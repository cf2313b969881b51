#!/bin/bash
# The fork rule's runs on one GPU (PERF.md section 6, PR 17): build the three
# kernel sources, train the base (the kernel route, seed 0, epochs 0-1000 of
# the 2500-epoch schedule), then fork its epoch-1000 checkpoint into each
# fork named in FORKS (ROUTE + SEED: kernel10, plain10, ...), side by side,
# each fork cut at DEADLINE_S seconds of this script and then evaluated by
# campaign_eval best. Run from the repository root:
#
#   bash multimodal_pl_tpu_torch/tools/campaign_forks.sh OUT ROOT "FORKS" DEADLINE_S
#
# e.g. OUT=out/forks1 ROOT=campaign FORKS="plain10 plain11 kernel13" DEADLINE_S=3490.
# OUT receives gpu.txt (card, power limit, versions), times.txt (seconds
# since the start at which each stage ended), smi.csv (nvidia-smi every 30
# s), base.train.jsonl, base.digest (the base state's sha256) and per fork
# NAME.train.log, NAME.train.jsonl and NAME.best.json;
# then `python -m multimodal_pl_tpu_torch.tools.campaign_seeds --fork
# ROUTE:SEED:OUT/NAME --add` counts a fork that reached epoch 1500.
set -u
OUT=$1; R=$2; FORKS=$3; DEADLINE=$4
for name in $FORKS; do
  case ${name%%[0-9]*} in kernel | plain) ;; *) echo "fork $name: not kernelSEED or plainSEED" >&2; exit 2 ;; esac
done
mkdir -p "$OUT"
export OMP_NUM_THREADS=1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/gpu.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' >> "$OUT/gpu.txt"
for n in conv3x3_gn gn_relu resize3d; do
  python -c "from multimodal_pl_tpu_torch.ops import _build; _build.build('$n')" > "$OUT/build_$n.log" 2>&1 &
done
wait
echo "built at $SECONDS s" >> "$OUT/times.txt"
nvidia-smi --query-gpu=timestamp,utilization.gpu,memory.used,power.draw,clocks.sm --format=csv -l 30 > "$OUT/smi.csv" &
SMI=$!
timeout $((DEADLINE - SECONDS)) python -m multimodal_pl_tpu_torch.tools.campaign run --root "$R" \
  --epochs 2500 --chunk 1000 --until 1000 --seed 0 > "$OUT/base.train.log" 2>&1
echo "base rc $? at $SECONDS s" >> "$OUT/times.txt"
cp "$R/snapshots/train.jsonl" "$OUT/base.train.jsonl"
BASE=$R/snapshots/ckpt_6000.pt
python -c "from multimodal_pl_tpu_torch.tools.campaign import checkpoint_digest as d; print(d('$BASE'))" > "$OUT/base.digest" 2>&1
LIMIT=$((DEADLINE - SECONDS))
echo "forks start at $SECONDS s, limit $LIMIT s" >> "$OUT/times.txt"
PIDS=()
for name in $FORKS; do
  route=${name%%[0-9]*}; S=${name#"$route"}
  flags=""; [ "$route" = plain ] && flags="--pallas_k2 false --pallas_gn false"
  snap=$R/fork_$name
  (
    timeout $LIMIT python -m multimodal_pl_tpu_torch.tools.campaign run --root "$R" --skip_gen \
      --snapshot_dir "$snap" --fork_from "$BASE" --epochs 2500 --chunk 1000 --until 1500 \
      --seed "$S" $flags > "$OUT/$name.train.log" 2>&1
    echo "$name rc $? at $SECONDS s" >> "$OUT/times.txt"
    cp "$snap/train.jsonl" "$OUT/$name.train.jsonl"
    python -m multimodal_pl_tpu_torch.tools.campaign_eval best --root "$R" --snapshot_dir "$snap" \
      --json "$OUT/$name.best.json" > "$OUT/$name.best.log" 2>&1
    echo "$name best rc $? at $SECONDS s" >> "$OUT/times.txt"
  ) &
  PIDS+=($!)
done
wait "${PIDS[@]}"
kill $SMI
wait $SMI 2>/dev/null
echo "done at $SECONDS s" >> "$OUT/times.txt"
cat "$OUT/times.txt"
