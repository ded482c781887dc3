#!/usr/bin/env bash
# Start an apsim_tpu_torch server on every host listed in a hosts file,
# through ssh (the counterpart of sbin/start-all.sh); without the file,
# start one locally.  Every host's daemon.sh start returns only once its
# server is up, and this script fails if any of them failed.
#
# Usage: start-all.sh [hosts file] [serve args...]
#   (default hosts file: <checkout>/conf/servers, one host a line)
set -euo pipefail
APSIM_HOME="$(cd "$(dirname "$0")/.." && pwd)"
HOSTS_FILE="${1:-$APSIM_HOME/conf/servers}"
shift || true
if [[ ! -f "$HOSTS_FILE" ]]; then
  echo "no hosts file at $HOSTS_FILE; starting locally" >&2
  exec "$APSIM_HOME/sbin_torch/daemon.sh" start "$@"
fi
remote="$(printf '%q ' "$APSIM_HOME/sbin_torch/daemon.sh" start "$@")"
pids=() hosts=()
while read -r host; do
  [[ -z "$host" || "$host" == \#* ]] && continue
  echo "starting on $host"
  ssh "$host" "$remote" &
  pids+=("$!") hosts+=("$host")
done < "$HOSTS_FILE"
failed=0
for k in "${!pids[@]}"; do
  if ! wait "${pids[$k]}"; then
    echo "start failed on ${hosts[$k]}" >&2
    failed=1
  fi
done
exit "$failed"
