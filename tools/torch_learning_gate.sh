#!/usr/bin/env bash
# The learning gates through the PyTorch port's runners, on one CUDA card.
#
#     bash tools/torch_learning_gate.sh [fv2p|mgaf|nuscenes|waymo] [EPOCHS_TO_SCORE...]
#
# fv2p (the default): train tools/cfgs/kitti_models/FV2P/fv2p_overfit.yaml on
# the committed KITTI fixture (data/kitti, 32 train scans; 200 epochs of 16
# steps, a checkpoint every 25), then score the checkpoints of epochs 175 and
# 200 on the 24 val scans with the official KITTI AP.
#
# mgaf: train tools/cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd_overfit.yaml on
# the same fixture at the yaml's schedule (300 epochs of 8 steps of batch 4,
# a checkpoint every 50, as the JAX package's gate saved them; the rulebooks
# built on the card), then score the checkpoints of epochs 250 and 300 on
# the 24 val scans with the official KITTI AP. The JAX package's gate scored
# epoch 250 (artifacts/learning_gate/PROVENANCE.md). The seconds the whole
# schedule took go to train_s.txt.
#
# nuscenes: train tools/cfgs/nuscenes_models/cbgs_second_multihead_overfit.yaml
# on the committed nuScenes fixture (data/nuscenes: the CBGS-resampled train
# split, 40 samples, 10 steps an epoch; the yaml's 120-epoch schedule, a
# checkpoint every 40, the rulebooks built on the card), then score the
# checkpoint of epoch 80 on the 2 val scans with the native nuScenes metrics
# (mAP, NDS), as the JAX package's gate did
# (artifacts/learning_gate/PROVENANCE.md).
#
# waymo: write the Waymo gate fixture (data/waymo_gate: 4 train and 2 val
# frames of 30000 points, two vehicles and a pedestrian each) with the port's
# generator, python -m fv2p_torch.tools.make_synthetic_waymo; train
# tools/cfgs/waymo_models/MGAF-3DSSD/waymo_mgaf-3dssd_overfit.yaml on it for
# 1000 epochs (one step of batch 4 each, a checkpoint every 100, the rulebooks
# built on the card), then on to
# epoch 1300 (the runner resumes from checkpoint 1000 with a one-cycle
# schedule over 1300 epochs: the JAX package's 300-epoch fine-tune), and
# score the checkpoints of epochs 1000 and 1300 on the 2 val frames with the
# native Waymo metrics (Vehicle L1/L2 AP and APH). The seconds the first 100
# epochs took go to train_100_epochs_s.txt.
#
# Checkpoints stay under output/torch/<group>/<yaml>/gate/; the loss of every
# step (metrics.jsonl), the eval results (result.json per checkpoint) and the
# card's name and power limit go to chiprun_out/gate/ (fv2p),
# chiprun_out/gate_mgaf/, chiprun_out/gate_nuscenes/ or chiprun_out/gate_waymo/. A strict level-capacity overflow on an augmented
# scan stops a train run; the script then starts the runner again, which
# resumes from the newest checkpoint (at most 3 starts).
set -euo pipefail
cd "$(dirname "$0")/.."
GATE=fv2p
if [ "${1:-}" = fv2p ] || [ "${1:-}" = mgaf ] || [ "${1:-}" = nuscenes ] \
    || [ "${1:-}" = waymo ]; then
  GATE=$1
  shift
fi
STAGES=""
if [ "$GATE" = waymo ]; then
  CFG=tools/cfgs/waymo_models/MGAF-3DSSD/waymo_mgaf-3dssd_overfit.yaml
  RUN=output/torch/waymo_models/MGAF-3DSSD/waymo_mgaf-3dssd_overfit/gate
  OUT=chiprun_out/gate_waymo
  EPOCHS="${*:-1000 1300}"
  INTERVAL=100
  SCORES='recall_rcnn_0.3|sec_per_example|OBJECT_TYPE_TYPE_VEHICLE'
  # rulebooks built on the card: an epoch is one batch, and with host tables
  # most of it would wait for the loader to build them
  TRAIN_EXTRA="--rulebooks device"
  # the 1000-epoch schedule, then the fine-tune to 1300
  STAGES="--epochs 1000;--epochs 1300"
  python3 -m fv2p_torch.tools.make_synthetic_waymo data/waymo_gate > /dev/null
elif [ "$GATE" = mgaf ]; then
  CFG=tools/cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd_overfit.yaml
  RUN=output/torch/kitti_models/MGAF-3DSSD/mgaf-3dssd_overfit/gate
  OUT=chiprun_out/gate_mgaf
  EPOCHS="${*:-250 300}"
  INTERVAL=50
  SCORES='recall_rcnn_0.(3|7)|sec_per_example|AP_R40|3d   AP'
  TRAIN_EXTRA="--rulebooks device"
elif [ "$GATE" = nuscenes ]; then
  CFG=tools/cfgs/nuscenes_models/cbgs_second_multihead_overfit.yaml
  RUN=output/torch/nuscenes_models/cbgs_second_multihead_overfit/gate
  OUT=chiprun_out/gate_nuscenes
  EPOCHS="${*:-80}"
  INTERVAL=40
  SCORES='recall_rcnn_0.3|sec_per_example|^.*(mAP|NDS): '
  # rulebooks built on the card: with host tables the loader's wait takes
  # most of each step
  TRAIN_EXTRA="--rulebooks device"
else
  CFG=tools/cfgs/kitti_models/FV2P/fv2p_overfit.yaml
  RUN=output/torch/kitti_models/FV2P/fv2p_overfit/gate
  OUT=chiprun_out/gate
  EPOCHS="${*:-175 200}"
  INTERVAL=25
  SCORES='recall_rcnn_0.3|sec_per_example|3d   AP'
  TRAIN_EXTRA=""
fi
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
START=$(date +%s)
IFS=';' read -r -a STAGE_ARGS <<< "${STAGES:- }"
for stage in "${STAGE_ARGS[@]}"; do
  for attempt in 1 2 3; do
    # shellcheck disable=SC2086
    if python3 -m fv2p_torch.tools.train --cfg_file "$CFG" --extra_tag gate \
        --ckpt_save_interval "$INTERVAL" --workers 4 --fix_random_seed $TRAIN_EXTRA $stage \
        >> "$OUT/train_log.txt" 2>&1; then
      break
    fi
    echo "train run $attempt stopped: $(grep -E 'Error' "$OUT/train_log.txt" | tail -1)"
  done
done
if [ "$GATE" = waymo ] && [ -f "$RUN/ckpt/checkpoint_epoch_100.pth" ]; then
  echo $(( $(stat -c %Y "$RUN/ckpt/checkpoint_epoch_100.pth") - START )) \
    | tee "$OUT/train_100_epochs_s.txt"
fi
if [ "$GATE" = mgaf ]; then
  echo $(( $(date +%s) - START )) | tee "$OUT/train_s.txt"
fi
grep -E 'mean loss|saved checkpoint|resumed' "$OUT/train_log.txt" | tail -12 || true
cp "$RUN/metrics.jsonl" "$OUT/"
for e in $EPOCHS; do
  python3 -m fv2p_torch.tools.test --cfg_file "$CFG" --extra_tag gate --workers 4 \
      --ckpt "$RUN/ckpt/checkpoint_epoch_$e.pth" --output_dir "$OUT/eval_$e" \
      > "$OUT/eval_$e.log" 2>&1
  grep -E "$SCORES" "$OUT/eval_$e.log" | head -12 || true
done
