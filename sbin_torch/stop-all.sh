#!/usr/bin/env bash
# Stop the apsim_tpu_torch server on every host listed in a hosts file,
# through ssh (the counterpart of sbin/stop-all.sh); without the file, stop
# the local one.  Each stop sends SIGINT, so each server checkpoints; this
# script fails if any stop failed.
#
# Usage: stop-all.sh [hosts file]   (default <checkout>/conf/servers)
set -euo pipefail
APSIM_HOME="$(cd "$(dirname "$0")/.." && pwd)"
HOSTS_FILE="${1:-$APSIM_HOME/conf/servers}"
if [[ ! -f "$HOSTS_FILE" ]]; then
  exec "$APSIM_HOME/sbin_torch/daemon.sh" stop
fi
remote="$(printf '%q ' "$APSIM_HOME/sbin_torch/daemon.sh" stop)"
pids=() hosts=()
while read -r host; do
  [[ -z "$host" || "$host" == \#* ]] && continue
  echo "stopping on $host"
  ssh "$host" "$remote" &
  pids+=("$!") hosts+=("$host")
done < "$HOSTS_FILE"
failed=0
for k in "${!pids[@]}"; do
  if ! wait "${pids[$k]}"; then
    echo "stop failed on ${hosts[$k]}" >&2
    failed=1
  fi
done
exit "$failed"
