# Two sets of --trace 0 runs of one cell with the same seeds, then
# --trace 1 runs, each printing its correct, metrics and compared numbers
# (the measurements that set the bounds of BENCHMARK.json):
#   bash perfbench/sets.sh OUTDIR WORKLOAD SEED,SEED,... TRACED_SEED,...
set -u
O=$1; W=$2; mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -1
run() {  # set seed trace
  local s0=$(date +%s)
  timeout -s KILL 700 python3 -m perfbench.run --workload $W --seed $2 --seconds $(python3 -c "import json; print(json.load(open('BENCHMARK.json'))['run_seconds'])") --trace $3 > $O/$1_$2.json 2> $O/$1_$2.err
  echo "$1 seed $2 trace $3 rc=$? $(( $(date +%s) - s0 )) s $(python3 -c "import json,sys; d=json.load(open('$O/$1_$2.json')); print(d['correct'], {k: round(v['value'],4) for k,v in d['metrics'].items()}, {k: round(v['value'],5) for k,v in d['check'].items()}, round(d['run']['window_samples_per_s'],2), round(d['run']['window_step_ms_p90'],2))" 2>&1 | tail -1)"
}
for s in ${3//,/ }; do run A $s 0; done
for s in ${3//,/ }; do run B $s 0; done
for s in ${4//,/ }; do run T $s 1; done
