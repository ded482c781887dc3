#!/usr/bin/env bash
# Bring up N server containers of the PyTorch port on one machine, one card
# each (the counterpart of docker/bin/start-cluster.sh): container i gets
# card i (--gpus device=i), the store volume and the corpus.
#
# Two modes:
#   default            N INDEPENDENT servers, each owning its own index
#   APSIM_MULTIHOST=1  ONE coordinated cluster: every container joins one
#                      torch.distributed group (MASTER_ADDR = compute-node-0,
#                      MASTER_PORT = its store's port, WORLD_SIZE = N,
#                      RANK = i); node 0 fronts the RPC service and ships
#                      its op log to the others, which replay it in
#                      lockstep (`serve --mesh --replicate`)
#
# Usage: start-cluster.sh [N]   (default 2)
#   APSIM_IMAGE  image name      (default apsim-tpu-torch)
#   APSIM_DATA   host corpus dir (default ./data/maildir_small)
#   APSIM_STORE  host store dir  (default ./store, shared with
#                                 start-preprocess.sh)
set -euo pipefail
N="${1:-2}"
IMAGE="${APSIM_IMAGE:-apsim-tpu-torch}"
DATA="${APSIM_DATA:-$(pwd)/data/maildir_small}"
STORE="${APSIM_STORE:-$(pwd)/store}"
mkdir -p "$STORE"
if ! docker network inspect apsim-net > /dev/null 2>&1; then
  docker network create apsim-net
fi
for i in $(seq 0 $((N - 1))); do
  port=$((2551 + i))
  if [[ "${APSIM_MULTIHOST:-0}" == "1" ]]; then
    # NCCL (the group's backend on the card) reaches the other containers'
    # cards through shared memory and CUDA IPC handles; a container's own
    # IPC namespace and 64 MB /dev/shm hide those from it, so the
    # containers share the host's (--ipc=host)
    docker run -d --name "compute-node-$i" --network apsim-net \
      --gpus "device=$i" --ipc=host \
      -e "MASTER_ADDR=compute-node-0" \
      -e "MASTER_PORT=9876" \
      -e "WORLD_SIZE=$N" \
      -e "RANK=$i" \
      -p "$port:2551" \
      -v "$DATA:/root/data:ro" \
      -v "$STORE:/root/store" \
      "$IMAGE" serve --host 0.0.0.0 --port 2551 --mesh \
        --store /root/store --replicate compute-node-0:9877
    echo "compute-node-$i on :$port, card $i (cluster member $i/$N)"
  else
    docker run -d --name "compute-node-$i" --network apsim-net \
      --gpus "device=$i" \
      -p "$port:2551" \
      -v "$DATA:/root/data:ro" \
      -v "$STORE:/root/store" \
      "$IMAGE" serve --host 0.0.0.0 --port 2551 --store /root/store
    echo "compute-node-$i on :$port, card $i"
  fi
done
