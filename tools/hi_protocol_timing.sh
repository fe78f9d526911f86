#!/bin/bash
# Short runs of the flagship protocol (EGM 300, epochs 0..1, predict at full
# depth) on one card: one process alone, then five concurrent (one seed
# each), then the five beside a short BGM imputation run.  Each seed line
# carries fit_s and egm_s: ms per EGM iteration = egm_s / 301, ms per
# training step ~ (fit_s - egm_s) / 1250.  Logs under $OUT/timing.
# Run from the repository's root: [OUT=dir] bash tools/hi_protocol_timing.sh
set -u
OUT=${OUT:-protocol_out}/timing; mkdir -p $OUT
export OMP_NUM_THREADS=2
nproc; nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python -c 'from bayesgm_torch.ops._build import load_library; import time; t=time.time(); load_library("bnn_hosteps.cu"); print("build", time.time()-t)'
SHORT="--lr_decay cosine --egm 300 --epochs 1"
t0=$(date +%s%N)
python -m bayesgm_torch.benchmarks.hi_protocol $SHORT --seeds 123 > $OUT/alone.log 2>&1
t1=$(date +%s%N); echo "alone wall $(( (t1-t0)/1000000 )) ms"
grep '^{' $OUT/alone.log
for s in 123 456 789 1011 1213; do
  python -m bayesgm_torch.benchmarks.hi_protocol $SHORT --seeds $s > $OUT/five_$s.log 2>&1 &
done
wait
t2=$(date +%s%N); echo "five wall $(( (t2-t1)/1000000 )) ms"
grep -h '^{' $OUT/five_*.log
for s in 123 456 789 1011 1213; do
  python -m bayesgm_torch.benchmarks.hi_protocol $SHORT --seeds $s > $OUT/six_$s.log 2>&1 &
done
python -m bayesgm_torch.benchmarks.bgm_impute --lr_decay cosine --egm 300 --epochs 1 --n_mcmc 200 --burn_in 200 > $OUT/six_bgm.log 2>&1 &
wait
t3=$(date +%s%N); echo "six wall $(( (t3-t2)/1000000 )) ms"
grep -h '^{' $OUT/six_*.log
tail -n 3 $OUT/*.log | grep -i -B2 error || true
