#!/bin/bash
# Five seeds of the flagship protocol at full depth (--lr_decay cosine, data
# seed 0), one process each on one card, checkpointed under $OUT/state
# (logs seed<s>.log, eval metrics metrics_seed<s>.jsonl).  Each process
# stops after LIMIT seconds (default 3450); run the script again with
# RESUME set to a copy of that state folder and every seed resumes after
# its last eval epoch, bit-equal to an uninterrupted run.  WITH_BGM=1 also
# runs the BGM imputation protocol (log $OUT/bgm_impute.log).
# Run from the repository's root:
#   [OUT=dir] [LIMIT=s] [RESUME=dir] [WITH_BGM=1] bash tools/hi_protocol_seeds.sh
set -u
LIMIT=${LIMIT:-3450}
OUT=${OUT:-protocol_out}
STATE=$OUT/state; mkdir -p $STATE
if [ -n "${RESUME:-}" ] && [ -d "$RESUME" ]; then cp -r "$RESUME"/. $STATE/; fi
export OMP_NUM_THREADS=2
nproc; nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'from bayesgm_torch.ops._build import load_library; load_library("bnn_hosteps.cu")'
date -u
for s in 123 456 789 1011 1213; do
  echo "=== call start $(date -u)" >> $STATE/seed$s.log
  timeout -k 20 $LIMIT python -m bayesgm_torch.benchmarks.hi_protocol --lr_decay cosine \
    --seeds $s --state_dir $STATE >> $STATE/seed$s.log 2>&1 &
done
if [ "${WITH_BGM:-0}" = 1 ]; then
  timeout -k 20 $LIMIT python -m bayesgm_torch.benchmarks.bgm_impute --lr_decay cosine \
    > $OUT/bgm_impute.log 2>&1 &
fi
wait
date -u
# keep only each seed's newest checkpoint, so that the state stays small
for d in $STATE/checkpoints/HI_protocol/seed*; do
  ls -1 $d/ckpt-*.npz 2>/dev/null | sort -t- -k2 -n | head -n -1 | xargs -r rm -f
done
du -sh $STATE
grep -h -e '^{' -e SUMMARY $STATE/seed*.log $OUT/bgm_impute.log 2>/dev/null
for s in 123 456 789 1011 1213; do echo "seed $s: $(tail -c 300 $STATE/seed$s.log | tail -2)"; done
