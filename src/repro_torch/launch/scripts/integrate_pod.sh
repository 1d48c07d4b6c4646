#!/usr/bin/env bash
# Per-host integration entrypoint of the port: the paper's multi-function
# workload as a fault-tolerant multi-host job (checkpointed rounds and
# restart-on-failure), with the same wiring as train_pod.sh.
#
# Example (2 hosts, repro's env contract):
#   REPRO_COORD=10.0.0.1:8476 REPRO_NUM_PROCS=2 REPRO_PROC_ID=0 \
#     ./integrate_pod.sh --n-functions 1000 --samples 1000000 --use-kernel \
#       --ckpt-dir /ckpt
# repro_torch.launch.multihost.initialize_if_needed() joins the process
# group that the environment describes (or torchrun's) before the mesh is
# built, so --mesh sees every rank.
set -euo pipefail

cd "$(dirname "$0")/../../../.."

export PYTHONPATH="${PWD}/src${PYTHONPATH:+:$PYTHONPATH}"

exec python -m repro_torch.launch.integrate --mesh "$@"
