#!/usr/bin/env bash
# Interactive client container against the running cluster, with the
# PyTorch port's image (the counterpart of docker/bin/start-client.sh): the
# `client` terminal's start/test/quit.  The client needs no card.
#
# Usage: start-client.sh [host:port ...]   (default compute-node-0:2551)
#   APSIM_IMAGE  image name      (default apsim-tpu-torch)
#   APSIM_DATA   host corpus dir (default ./data/maildir_small)
#   APSIM_STORE  host store dir  (default ./store; lets `start <table>`
#                                 bulk-load what start-preprocess.sh wrote)
set -euo pipefail
IMAGE="${APSIM_IMAGE:-apsim-tpu-torch}"
DATA="${APSIM_DATA:-$(pwd)/data/maildir_small}"
STORE="${APSIM_STORE:-$(pwd)/store}"
REMOTES=()
for r in "${@:-compute-node-0:2551}"; do
  REMOTES+=(--remote "$r")
done
docker run -t -i --rm --name apsim-client \
  --network apsim-net \
  -v "$DATA:/root/data:ro" \
  -v "$STORE:/root/store:ro" \
  "$IMAGE" client "${REMOTES[@]}"
