#!/usr/bin/env bash
# Per-host training entrypoint for multi-host deployments of the port.
#
# Run once on every host (one process per card), e.g. under torchrun:
#   torchrun --nnodes 2 --nproc-per-node 8 --node-rank 0 \
#     --master-addr 10.0.0.1 --master-port 8476 \
#     src/repro_torch/launch/scripts/train_pod.sh --arch stablelm-3b --steps 1000 \
#     --ckpt-dir /ckpt
# or with repro's env contract, one process per host:
#   REPRO_COORD=10.0.0.1:8476 REPRO_NUM_PROCS=2 REPRO_PROC_ID=0 \
#     ./train_pod.sh --arch stablelm-3b --steps 1000 --ckpt-dir /ckpt
# repro_torch.launch.multihost.initialize_if_needed() joins the process
# group that the environment describes (REPRO_COORD / REPRO_NUM_PROCS /
# REPRO_PROC_ID, or torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT)
# before the mesh is built, so --mesh spans every rank; checkpoints are
# mesh-independent, so a restart on another number of hosts resumes.
set -euo pipefail

cd "$(dirname "$0")/../../../.."

export PYTHONPATH="${PWD}/src${PYTHONPATH:+:$PYTHONPATH}"

exec python -m repro_torch.launch.train --mesh "$@"
