#!/bin/bash
# Launcher — the counterpart of the repo's mpinc.sh (the reference's
# mpinc.sh:20-29).  The reference asked the binary for its required MPI
# size and exec'd mpirun; here one Python process drives the deck's shards
# on the visible cards, so this wrapper prints the deck's device demand
# and runs the module.  Runs over several processes go through torchrun:
#   torchrun --standalone --nproc-per-node=2 -m pinc_tpu_torch <input.ini>
set -euo pipefail
if [ $# -lt 1 ]; then
    echo "usage: pinc_tpu_torch/mpinc.sh <input.ini> [section:key=value ...]" >&2
    exit 2
fi
cd "$(dirname "$0")/.."
NP=$(python3 -m pinc_tpu_torch "$@" getnp)
echo "deck requests ${NP} device(s)" >&2
exec python3 -m pinc_tpu_torch "$@"
