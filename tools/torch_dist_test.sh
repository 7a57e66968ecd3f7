#!/usr/bin/env bash
# Data-parallel testing with the PyTorch port: GPUS processes on this
# machine, one card each, through torch.distributed.run.
#   tools/torch_dist_test.sh CONFIG CHECKPOINT GPUS [tools/torch_test.py arguments]
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
PORT=${PORT:-29500}
exec "${PYTHON:-python3}" -m torch.distributed.run --nproc_per_node="$GPUS" --master_port="$PORT" \
    "$(dirname "$0")/torch_test.py" "$CONFIG" "$CHECKPOINT" --launcher pytorch "$@"
