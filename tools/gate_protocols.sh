#!/bin/bash
# The gate runners at full depth on one card, the runs sharing it as
# concurrent processes: binary_ate base at seeds 123 456 789 and
# identifiable at seed 123, FullMCMC (fullmcmc_*: fit, weight-space HMC,
# predict) and the 3-member ensemble (ensemble_*) at seeds 123 456 789 (data
# seed 7, the runner's defaults), sun_colangelo_ivae's SUN and COLANGELO
# runs (seed 42) and mnist_inpaint --lr_decay cosine (seed 42); also
# identifiable at seeds 456 789 (binary_ident_*) and FullMCMC through
# tools/fullmcmc_stage_split.py (split_*: binary_ate's recipe read after
# fit, weight HMC and predict, at seeds 123 789 1011 1213 1415 1617 1819 2021
# 42; flagship_split_*: hi_protocol --lr_decay cosine --fullmcmc at seeds 123
# 456 789), its fitted state under $OUT/state/split/<run>.  RUNS picks a
# subset (default: the first thirteen).  An ensemble run fits its three members
# as three processes (binary_ate --member i, logs <run>_m<i>.log), then runs
# the ensemble command, which resumes every member after its last epoch and
# predicts.  Each run is checkpointed under $OUT/state (log <run>.log) and
# stops after LIMIT seconds (default 3450) from the start of the call; run
# the script again with RESUME set to a copy of that state folder and every
# run resumes after its last eval epoch (an ensemble member whose line is in
# its log is not fitted again).
# SHORT=1 runs the timing layout instead (EGM 300, epochs 0..1, MH 200 + 200,
# HMC 100 + 100): each run of ALONE (default binary_123 sun mnist) alone,
# then every run of RUNS concurrently; logs under $OUT/timing.  ms per EGM
# iteration = egm_s / 301; per MH or HMC step ~ predict_s / 400 (MNIST / 200).
# Run from the repository's root:
#   [OUT=dir] [LIMIT=s] [RESUME=dir] [RUNS="..."] [SHORT=1 [ALONE="..."]] \
#     bash tools/gate_protocols.sh
set -u
LIMIT=${LIMIT:-3450}
OUT=${OUT:-gate_out}
RUNS=${RUNS:-"binary_123 binary_456 binary_789 binary_ident_123 fullmcmc_123 fullmcmc_456
fullmcmc_789 ensemble_123 ensemble_456 ensemble_789 sun colangelo mnist"}
ALONE=${ALONE:-"binary_123 sun mnist"}
MEMBERS="0 1 2"  # the ensemble's members (binary_ate's --n_members 3)
declare -A CMD=(
  [binary_123]="binary_ate --seed 123"
  [binary_456]="binary_ate --seed 456"
  [binary_789]="binary_ate --seed 789"
  [binary_ident_123]="binary_ate --engine identifiable --seed 123"
  [fullmcmc_123]="binary_ate --engine fullmcmc --seed 123"
  [fullmcmc_456]="binary_ate --engine fullmcmc --seed 456"
  [fullmcmc_789]="binary_ate --engine fullmcmc --seed 789"
  [ensemble_123]="binary_ate --engine ensemble --seed 123"
  [ensemble_456]="binary_ate --engine ensemble --seed 456"
  [ensemble_789]="binary_ate --engine ensemble --seed 789"
  [sun]="sun_colangelo_ivae --runs SUN"
  [colangelo]="sun_colangelo_ivae --runs COLANGELO"
  [mnist]="mnist_inpaint --lr_decay cosine"
  [binary_ident_456]="binary_ate --engine identifiable --seed 456"
  [binary_ident_789]="binary_ate --engine identifiable --seed 789"
)
for s in 123 789 1011 1213 1415 1617 1819 2021 42; do
  CMD[split_$s]="stage_split --seed $s"
done
for s in 123 456 789; do
  CMD[flagship_split_$s]="stage_split --flagship --seed $s"
done
declare -A CKPT=(  # each run's checkpoint folders under the state folder (globs)
  [binary_123]=binary_ate/base_seed123 [binary_456]=binary_ate/base_seed456
  [binary_789]=binary_ate/base_seed789 [binary_ident_123]=binary_ate/identifiable_seed123
  [fullmcmc_123]=binary_ate/fullmcmc_seed123 [fullmcmc_456]=binary_ate/fullmcmc_seed456
  [fullmcmc_789]=binary_ate/fullmcmc_seed789
  [ensemble_123]="binary_ate_member*/ensemble_seed123"
  [ensemble_456]="binary_ate_member*/ensemble_seed456"
  [ensemble_789]="binary_ate_member*/ensemble_seed789"
  [sun]=ivae_SUN/seed42 [colangelo]=ivae_COLANGELO/seed42 [mnist]=mnist_inpaint/seed42
  [binary_ident_456]=binary_ate/identifiable_seed456
  [binary_ident_789]=binary_ate/identifiable_seed789
)
for s in 123 789 1011 1213 1415 1617 1819 2021 42; do
  CKPT[split_$s]=binary_ate/fullmcmc_seed$s
done
for s in 123 456 789; do
  CKPT[flagship_split_$s]=HI_protocol/seed$s
done
echo "nproc $(nproc), online $(nproc --all)"
export OMP_NUM_THREADS=2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python -c 'from bayesgm_torch.ops._build import load_library; import time; t=time.time(); load_library("bnn_hosteps.cu"); print("build", time.time()-t)'
DEADLINE=$(( $(date +%s) + LIMIT ))

# a log that holds its result line (the stage split's last line is stage A)
ended() {
  grep -q '^{' "$1" 2>/dev/null && { ! grep -q '"stage"' "$1" || grep -q '"stage": "A"' "$1"; }
}

launch() {  # launch <log> <runner and flags...>: one process, stopped at the deadline
  local log=$1; shift
  echo "=== call start $(date -u)" >> $log
  local cmd="python -m bayesgm_torch.benchmarks.$1"
  [ $1 = stage_split ] && cmd="python tools/fullmcmc_stage_split.py"
  shift
  timeout -k 20 $(( DEADLINE - $(date +%s) )) $cmd "$@" >> $log 2>&1
}

start() {  # start <run> <state dir> <log> [extra flags]
  local r=$1 st=$2 log=$3; shift 3
  local out="--out $st/split/$r"
  # mnist_inpaint ends within one call, and its 35 MB checkpoint would crowd
  # what a call may bring back: it runs without a state folder
  [ $r = mnist ] && st= || st="--state_dir $st"
  case $r in *split_*) st="$st $out" ;; esac
  case $r in
    ensemble_*)  # the members in parallel, then the ensemble once all have ended
      (
        for i in $MEMBERS; do
          ended ${log%.log}_m$i.log || launch ${log%.log}_m$i.log ${CMD[$r]} $st --member $i "$@" &
        done
        wait
        for i in $MEMBERS; do ended ${log%.log}_m$i.log || exit 0; done
        launch $log ${CMD[$r]} $st "$@"
      ) & ;;
    *) launch $log ${CMD[$r]} $st "$@" & ;;
  esac
}

if [ "${SHORT:-0}" = 1 ]; then
  T=$OUT/timing; mkdir -p $T
  short() {  # the cut flags of one run
    case $1 in
      mnist) echo "--egm 300 --epochs 1 --n_mcmc 100 --burn_in 100" ;;
      *) echo "--egm 300 --epochs 1 --n_mcmc 200 --burn_in 200" ;;
    esac
  }
  for r in $ALONE; do
    t0=$(date +%s%N)
    start $r $T/alone $T/alone_$r.log $(short $r); wait
    echo "alone $r wall $(( ($(date +%s%N) - t0) / 1000000 )) ms"
  done
  t0=$(date +%s%N)
  for r in $RUNS; do start $r $T/together $T/together_$r.log $(short $r); done
  wait
  echo "together wall $(( ($(date +%s%N) - t0) / 1000000 )) ms"
  du -sh $T/together/checkpoints/*/* 2>/dev/null
  rm -rf $T/alone/checkpoints $T/together/checkpoints
  grep -H -e '^{' -e 'Acceptance Rate' -e 'acceptance' $T/*.log
  grep -l Traceback $T/*.log && exit 1
  exit 0
fi

STATE=$OUT/state; mkdir -p $STATE
if [ -n "${RESUME:-}" ] && [ -d "$RESUME" ]; then cp -r "$RESUME"/. $STATE/; fi
date -u
for r in $RUNS; do
  if ended $STATE/$r.log; then echo "$r: ended in an earlier call"; continue; fi
  start $r $STATE $STATE/$r.log
done
wait
date -u
# keep only the newest checkpoint of each run that has not ended, so that the
# state stays small
for r in $RUNS; do
  for d in $STATE/checkpoints/${CKPT[$r]}; do
    [ -d "$d" ] || continue
    if ended $STATE/$r.log; then rm -rf $d; continue; fi
    ls -1 $d/ckpt-*.npz 2>/dev/null | sort -t- -k2 -n | head -n -1 | xargs -r rm -f
  done
done
du -sh $STATE; du -sh $STATE/checkpoints/*/* 2>/dev/null
grep -H -e '^{' -e '^RESULT' -e 'Acceptance Rate' $STATE/*.log
for r in $RUNS; do echo "$r: $(tail -c 300 $STATE/$r.log 2>/dev/null | tail -2)"; done
