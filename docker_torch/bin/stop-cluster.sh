#!/usr/bin/env bash
# Stop and remove the compute-node-* containers (the counterpart of
# docker/bin/stop-cluster.sh).  `docker stop` sends the image's STOPSIGNAL,
# SIGINT, so each server writes its final checkpoint before it is removed.
# compute-node-0 goes first: in a replicated cluster its op log closing is
# what ends the followers cleanly.
set -euo pipefail
names="$(docker ps -a --filter 'name=^compute-node-' --format '{{.Names}}' |
  sort -V)"
for c in $names; do
  docker stop -t 60 "$c"
  docker rm "$c"
done
