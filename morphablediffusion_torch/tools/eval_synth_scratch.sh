#!/bin/bash
# End-to-end quality loop of the from-scratch synthetic recipe
# (configs/synth_scratch.yaml) on the PyTorch port: the train CLI's
# checkpoint -> the CFG sampler -> the 4-stage eval harness on held-out
# subjects, mirroring the reference flow docs/eval.md:20-40. The port's
# counterpart of the repository's tools/eval_synth_scratch.sh.
#
# Usage: morphablediffusion_torch/tools/eval_synth_scratch.sh <run_dir> [out_dir]
#   <run_dir> holds data/ and flame/ (the port's make_synthetic_facescape)
#   and logs/scratch/ckpt (python -m morphablediffusion_torch.apps.train
#   -l <run_dir>/logs -n scratch). Environment overrides: CKPT (the
#   checkpoint dir), DATA (the data tree), CFG, STEPS (sampler steps),
#   SUBJECTS and EXPRESSIONS (the held-out ones), KPT_WEIGHTS (default: the
#   shipped landmark net, the JAX package's msgpack, read by the port),
#   KPT_SIZE, IMAGE_SIZE, DEVICE (cpu to rehearse; default the CUDA card),
#   PYTHON. Writes metrics_{nvs,nes}.json and the strips into <out_dir>.
set -euo pipefail
HERE=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
REPO=$(cd "$HERE/../.." && pwd)
RUN=${1:?run dir (containing data/, flame/, logs/scratch/ckpt)}
OUT=${2:-$RUN/eval}
CKPT=${CKPT:-$RUN/logs/scratch/ckpt}
DATA=${DATA:-$RUN/data}
CFG=${CFG:-$REPO/configs/synth_scratch.yaml}
STEPS=${STEPS:-50}
SUBJECTS=${SUBJECTS:-021 022}
EXPRESSIONS=${EXPRESSIONS:-01 02}
KPT_WEIGHTS=${KPT_WEIGHTS:-$REPO/artifacts/landmark_net_synth.msgpack}
KPT_SIZE=${KPT_SIZE:-128}
IMAGE_SIZE=${IMAGE_SIZE:-128}
PYTHON=${PYTHON:-python}
DEV=()
[ -n "${DEVICE:-}" ] && DEV=(--device "$DEVICE")
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p "$OUT"

# stage 1: deterministic input/target view selection on the held-out subjects
# shellcheck disable=SC2086
"$PYTHON" -m morphablediffusion_torch.apps.eval_select_views \
    --data_dir "$DATA" --subjects $SUBJECTS --expressions $EXPRESSIONS \
    --output "$OUT/views.json"

# stage 2: generate all target views: nvs (same-expression input) and nes
# (novel expression: the input drawn from the other expression)
for MODE in nvs nes; do
  EXTRA=()
  # shellcheck disable=SC2206
  [ "$MODE" = nes ] && EXTRA=(--nes_exp $EXPRESSIONS)
  "$PYTHON" -m morphablediffusion_torch.apps.eval_generate \
      --data_dir "$DATA" --mode $MODE "${EXTRA[@]}" --cfg "$CFG" \
      --ckpt "$CKPT" --views_json "$OUT/views.json" \
      --output_dir "$OUT/gen_$MODE" --sample_steps "$STEPS" "${DEV[@]}"
done

# stage 3: 68-keypoint prediction on the GT views and the generated strips
"$PYTHON" -m morphablediffusion_torch.apps.eval_keypoints \
    --image_dir "$DATA" --output "$OUT/kpts_gt.json" \
    --backend native --weights "$KPT_WEIGHTS" --image_size "$KPT_SIZE" \
    --views_json "$OUT/views.json" "${DEV[@]}"
for MODE in nvs nes; do
  "$PYTHON" -m morphablediffusion_torch.apps.eval_keypoints \
      --image_dir "$OUT/gen_$MODE" --output "$OUT/kpts_$MODE.json" \
      --backend native --weights "$KPT_WEIGHTS" --image_size "$KPT_SIZE" \
      --strips --views_json "$OUT/views.json" "${DEV[@]}"
done

# stage 4: SSIM / PSNR / LPIPS / FID / PCK summary; --fid_backend clip: the
# FID over the run's own CLIP tower (Inception weights need a download)
for MODE in nvs nes; do
  "$PYTHON" -m morphablediffusion_torch.apps.eval_2d \
      --data_dir "$DATA" --generated_dir "$OUT/gen_$MODE" \
      --views_json "$OUT/views.json" --mode $MODE \
      --pred_kpts "$OUT/kpts_$MODE.json" --gt_kpts "$OUT/kpts_gt.json" \
      --image_size "$IMAGE_SIZE" --fid_backend clip --ckpt "$CKPT" --cfg "$CFG" \
      "${DEV[@]}" | tee "$OUT/metrics_$MODE.json"
done
