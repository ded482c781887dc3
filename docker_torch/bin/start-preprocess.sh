#!/usr/bin/env bash
# ETL container: raw corpus -> TF-IDF vectors -> shared vector store, with
# the PyTorch port's image (the counterpart of docker/bin/start-preprocess.sh;
# the ETL runs on the host CPU and needs no card).
#
# Usage: start-preprocess.sh [table]
#   APSIM_IMAGE  image name          (default apsim-tpu-torch)
#   APSIM_DATA   host corpus dir     (default ./data/maildir_small)
#   APSIM_STORE  host store dir      (default ./store, shared with
#                                     start-cluster.sh / start-client.sh)
set -euo pipefail
TABLE="${1:-SMALL_DATA}"
IMAGE="${APSIM_IMAGE:-apsim-tpu-torch}"
DATA="${APSIM_DATA:-$(pwd)/data/maildir_small}"
STORE="${APSIM_STORE:-$(pwd)/store}"
mkdir -p "$STORE"
docker run --rm --name apsim-preprocess \
  -v "$DATA:/root/data:ro" \
  -v "$STORE:/root/store" \
  "$IMAGE" etl /root/data --store /root/store --table "$TABLE"
echo "preprocess done: table $TABLE in $STORE"
