#!/bin/bash
# The gate runners at full depth on one card, seven processes sharing it:
# binary_ate base at seeds 123 456 789 and identifiable at seed 123 (data
# seed 7), sun_colangelo_ivae's SUN and COLANGELO runs (seed 42) and
# mnist_inpaint --lr_decay cosine (seed 42).  Each is checkpointed under
# $OUT/state (log <run>.log) and stops after LIMIT seconds (default 3450);
# run the script again with RESUME set to a copy of that state folder and
# every run resumes after its last eval epoch.
# SHORT=1 runs the timing layout instead (EGM 300, epochs 0..1, MH 200 + 200,
# HMC 100 + 100): binary_ate base, the SUN run and mnist_inpaint each alone,
# then all seven concurrent; logs under $OUT/timing.  ms per EGM iteration =
# egm_s / 301; per MH or HMC step ~ predict_s / 400 (MNIST / 200).
# Run from the repository's root:
#   [OUT=dir] [LIMIT=s] [RESUME=dir] [SHORT=1] bash tools/gate_protocols.sh
set -u
LIMIT=${LIMIT:-3450}
OUT=${OUT:-gate_out}
RUNS="binary_123 binary_456 binary_789 binary_ident_123 sun colangelo mnist"
declare -A CMD=(
  [binary_123]="binary_ate --seed 123"
  [binary_456]="binary_ate --seed 456"
  [binary_789]="binary_ate --seed 789"
  [binary_ident_123]="binary_ate --engine identifiable --seed 123"
  [sun]="sun_colangelo_ivae --runs SUN"
  [colangelo]="sun_colangelo_ivae --runs COLANGELO"
  [mnist]="mnist_inpaint --lr_decay cosine"
)
declare -A CKPT=(  # each run's checkpoint folder under the state folder
  [binary_123]=binary_ate/base_seed123 [binary_456]=binary_ate/base_seed456
  [binary_789]=binary_ate/base_seed789 [binary_ident_123]=binary_ate/identifiable_seed123
  [sun]=ivae_SUN/seed42 [colangelo]=ivae_COLANGELO/seed42 [mnist]=mnist_inpaint/seed42
)
echo "nproc $(nproc), online $(nproc --all)"
export OMP_NUM_THREADS=2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python -c 'from bayesgm_torch.ops._build import load_library; import time; t=time.time(); load_library("bnn_hosteps.cu"); print("build", time.time()-t)'

start() {  # start <run> <state dir> <log> [extra flags]
  local r=$1 st=$2 log=$3; shift 3
  # mnist_inpaint ends within one call, and its 35 MB checkpoint would crowd
  # what a call may bring back: it runs without a state folder
  [ $r = mnist ] && st= || st="--state_dir $st"
  echo "=== call start $(date -u)" >> $log
  timeout -k 20 $LIMIT python -m bayesgm_torch.benchmarks.${CMD[$r]} $st "$@" >> $log 2>&1 &
}

if [ "${SHORT:-0}" = 1 ]; then
  T=$OUT/timing; mkdir -p $T
  short() {  # the cut flags of one run
    case $1 in
      mnist) echo "--egm 300 --epochs 1 --n_mcmc 100 --burn_in 100" ;;
      *) echo "--egm 300 --epochs 1 --n_mcmc 200 --burn_in 200" ;;
    esac
  }
  for r in binary_123 sun mnist; do
    t0=$(date +%s%N)
    start $r $T/alone $T/alone_$r.log $(short $r); wait
    echo "alone $r wall $(( ($(date +%s%N) - t0) / 1000000 )) ms"
  done
  t0=$(date +%s%N)
  for r in $RUNS; do start $r $T/seven $T/seven_$r.log $(short $r); done
  wait
  echo "seven wall $(( ($(date +%s%N) - t0) / 1000000 )) ms"
  rm -rf $T/alone/checkpoints $T/seven/checkpoints
  grep -H -e '^{' -e 'Acceptance Rate' $T/*.log
  grep -l Traceback $T/*.log && exit 1
  exit 0
fi

STATE=$OUT/state; mkdir -p $STATE
if [ -n "${RESUME:-}" ] && [ -d "$RESUME" ]; then cp -r "$RESUME"/. $STATE/; fi
date -u
for r in $RUNS; do  # a run whose result line is in its log has ended
  if grep -q '^{' $STATE/$r.log 2>/dev/null; then echo "$r: ended in an earlier call"; continue; fi
  start $r $STATE $STATE/$r.log
done
wait
date -u
# keep only the newest checkpoint of each run that has not ended, so that the
# state stays small
for r in $RUNS; do
  d=$STATE/checkpoints/${CKPT[$r]}
  if grep -q '^{' $STATE/$r.log 2>/dev/null; then rm -rf $d; continue; fi
  ls -1 $d/ckpt-*.npz 2>/dev/null | sort -t- -k2 -n | head -n -1 | xargs -r rm -f
done
du -sh $STATE; du -sh $STATE/checkpoints/*/* 2>/dev/null
grep -H -e '^{' -e '^RESULT' -e 'Acceptance Rate' $STATE/*.log
for r in $RUNS; do echo "$r: $(tail -c 300 $STATE/$r.log | tail -2)"; done
