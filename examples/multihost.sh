#!/usr/bin/env bash
# Multi-host correlator run: the SAME command on every host, one process
# per host (here: 2 local processes with 4 virtual CPU devices each).
# Each process feeds only the sample span its mesh devices own
# (fxtpu.parallel.ingest.local_sample_span); process 0 writes the CSV.
# On GPU hosts, replace --coordinator with host0's address and drop
# --platform cpu and --local_devices: each process then drives one card.
set -e
COORD=${FXTPU_COORD:-127.0.0.1:9731}
REC=${1:?usage: multihost.sh recording.npy [extra flags...]}
shift || true
ARGS="--source replay --replay_file $REC --num_samp 16384 --resolution 256 \
      --mode spectrum --omit_plot --no_keyboard --output /tmp/vis_mh.csv \
      --num_processes 2 --coordinator $COORD --platform cpu \
      --local_devices 4 $*"
python -m fxtpu $ARGS --process_id 1 &
RANK1=$!
# if rank 0 dies, don't orphan rank 1 holding the coordinator port
trap 'kill $RANK1 2>/dev/null' EXIT
python -m fxtpu $ARGS --process_id 0
# bare `wait` always exits 0 — wait on the PID so a rank-1 failure fails
# the script instead of printing a success line over a partial product
wait $RANK1
trap - EXIT
echo "product: /tmp/vis_mh.csv"
