#!/usr/bin/env bash
# Run the insert -> first-result latency benchmark (the load generator)
# against a running apsim_tpu_torch server; prints one JSON line (the
# counterpart of sbin/start-test.sh).
#
# Usage: start-test.sh [host:port] [bench args...]   (default 127.0.0.1:2551)
#   APSIM_PYTHON  interpreter (default python3)
set -euo pipefail
APSIM_HOME="$(cd "$(dirname "$0")/.." && pwd)"
REMOTE="${1:-127.0.0.1:2551}"
shift || true
export PYTHONPATH="$APSIM_HOME${PYTHONPATH:+:$PYTHONPATH}"
exec "${APSIM_PYTHON:-python3}" -m apsim_tpu_torch.cli bench \
  --remote "$REMOTE" "$@"
