#!/usr/bin/env bash
# Data-parallel training with the PyTorch port: GPUS processes on this
# machine, one card each, through torch.distributed.run.
#   tools/torch_dist_train.sh CONFIG GPUS [tools/torch_train.py arguments]
CONFIG=$1
GPUS=$2
shift 2
PORT=${PORT:-29500}
exec "${PYTHON:-python3}" -m torch.distributed.run --nproc_per_node="$GPUS" --master_port="$PORT" \
    "$(dirname "$0")/torch_train.py" "$CONFIG" --launcher pytorch "$@"
