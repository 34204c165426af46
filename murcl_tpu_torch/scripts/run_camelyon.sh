#!/bin/sh
# One-command Camelyon16 runbook of the PyTorch/CUDA port: WSI files ->
# heatmaps, with resume (the counterpart of scripts/run_camelyon.sh).
#
# Chains the port's seven entry points, each run as
# `python -m murcl_tpu_torch.<cli>`: create_patches -> extract_features ->
# features_clustering -> build_manifest -> 3-stage MuRCL pretraining
# (murcl_tpu_torch/runs/pretrain.sh's flags) -> 3-stage RLMIL fine-tuning
# (murcl_tpu_torch/runs/finetune.sh's) -> CLAM attention heatmaps. Needs
# no OpenSlide, PIL, OpenCV, pandas or JAX: `.tif`/`.svs` pyramids are read
# by the port's TIFF reader (JPEG tiles by nvJPEG on the card). Every step
# resumes: the preprocessing CLIs skip existing outputs, and a trainer
# stage counts as done when its model_best.pth.tar (pretraining) or
# final_res.csv (fine-tuning) exists, else it runs with --resume.
#
# Usage:
#   sh murcl_tpu_torch/scripts/run_camelyon.sh SLIDE_DIR LABELS_CSV WORK_DIR [DEVICE]
#
#   SLIDE_DIR   directory of .tif/.svs slides
#   LABELS_CSV  case_id,label per slide (challenge reference labels)
#   WORK_DIR    output root (patches/, features/, manifest/, runs/, heatmaps/)
#   DEVICE      the card's index (default 0), or cpu; every step uses it
#               (JPEG tiles, the encoder, k-means, training, heatmaps)
#
# Tunables (env): WSI_FORMAT=.tif MAG=20 PATCH=256 K=10 FEAT_SIZE=1024 T=6
#   PRE_EPOCHS=100 FT_EPOCHS=40 BATCH=128 SEED=985 ENCODER=resnet18
#   DATASET=camelyon16 WEIGHTS=<pickled encoder params> (torchvision's
#   ImageNet weights, exported by python -m
#   murcl_tpu_torch.scripts.export_torchvision_weights, with torch alone
#   from a downloaded .pth: --state_dict resnet18-f37072fd.pth)

set -eu

SLIDE_DIR=${1:?usage: run_camelyon.sh SLIDE_DIR LABELS_CSV WORK_DIR [DEVICE]}
LABELS_CSV=${2:?missing LABELS_CSV}
WORK=${3:?missing WORK_DIR}
DEVICE=${4:-0}

WSI_FORMAT=${WSI_FORMAT:-.tif}
MAG=${MAG:-20}
PATCH=${PATCH:-256}
K=${K:-10}
FEAT_SIZE=${FEAT_SIZE:-1024}
T=${T:-6}
PRE_EPOCHS=${PRE_EPOCHS:-100}
FT_EPOCHS=${FT_EPOCHS:-40}
BATCH=${BATCH:-128}
SEED=${SEED:-985}
ENCODER=${ENCODER:-resnet18}
DATASET=${DATASET:-camelyon16}

REPO=$(cd "$(dirname "$0")/../.." && pwd)
cd "$REPO"
mkdir -p "$WORK"

# the preprocessing CLIs treat --exist_ok as overwrite (reference
# semantics); without it they skip existing outputs, which resumes 1-3
echo "== [1/7] tiling =="
python -m murcl_tpu_torch.create_patches \
  --slide_dir "$SLIDE_DIR" --save_dir "$WORK/patches" \
  --patch_size "$PATCH" --magnification "$MAG" \
  --wsi_format "$WSI_FORMAT" --overview --save_mask --device "$DEVICE"

echo "== [2/7] feature extraction ($ENCODER) =="
python -m murcl_tpu_torch.extract_features \
  --patch_dir "$WORK/patches" --save_dir "$WORK/features" \
  --image_encoder "$ENCODER" --device "$DEVICE" \
  ${WEIGHTS:+--weights "$WEIGHTS"} --resize_on_device

echo "== [3/7] k-means clustering (K=$K) =="
python -m murcl_tpu_torch.features_clustering \
  --feat_dir "$WORK/features/$ENCODER" --num_clusters "$K" \
  --seed "$SEED" --device "$DEVICE"

echo "== [4/7] manifest + split =="
python -m murcl_tpu_torch.build_manifest \
  --feat_dir "$WORK/features/$ENCODER" \
  --cluster_dir "$WORK/features/$ENCODER/k-means-$K" \
  --labels_csv "$LABELS_CSV" --out_dir "$WORK/manifest" \
  --dataset "$DATASET" --num_clusters "$K" --seed "$SEED"
CSV="$WORK/manifest/${DATASET}_${K}.csv"
SPLIT="$WORK/manifest/${DATASET}_split.json"

pretrain_stage() {
  _dir=$(find "$WORK/runs/pretrain" -path "*stage_$1*" -name model_best.pth.tar 2>/dev/null | head -1)
  if [ -n "$_dir" ]; then echo "pretrain stage $1 done, skip"; return; fi
  python -m murcl_tpu_torch.train_MuRCL \
    --dataset "$DATASET" --data_csv "$CSV" --data_split_json "$SPLIT" \
    --feat_size "$FEAT_SIZE" --preload --train_stage "$1" --T "$T" \
    --scheduler CosineAnnealingLR --batch_size "$BATCH" \
    --epochs "$PRE_EPOCHS" \
    --backbone_lr "$2" --fc_lr "$3" \
    --patience 10 --arch CLAM_SB --device "$DEVICE" \
    --base_save_dir "$WORK/runs/pretrain" --seed "$SEED" \
    --exist_ok --resume
}

finetune_stage() {
  _res=$(find "$WORK/runs/finetune" -path "*stage_$1*" -name final_res.csv 2>/dev/null | head -1)
  if [ -n "$_res" ]; then echo "finetune stage $1 done, skip"; return; fi
  python -m murcl_tpu_torch.train_RLMIL \
    --dataset "$DATASET" --data_csv "$CSV" --data_split_json "$SPLIT" \
    --train_data train --feat_size "$FEAT_SIZE" --preload \
    --train_method finetune --train_stage "$1" \
    --checkpoint_pretrained "$PRETRAINED" \
    --T "$T" --scheduler CosineAnnealingLR --batch_size 1 \
    --epochs "$FT_EPOCHS" \
    --backbone_lr "$2" --fc_lr "$3" \
    --arch CLAM_SB --device "$DEVICE" \
    --base_save_dir "$WORK/runs/finetune" --seed "$SEED" \
    --save_model --exist_ok --resume
}

echo "== [5/7] MuRCL pretraining, stages 1-3 (murcl_tpu_torch/runs/pretrain.sh) =="
pretrain_stage 1 0.0001 0.00005
pretrain_stage 2 0.0001 0.00005
pretrain_stage 3 0.00005 0.00001
PRETRAINED=$(find "$WORK/runs/pretrain" -path "*stage_3*" -name model_best.pth.tar | head -1)
[ -n "$PRETRAINED" ] || { echo "pretrain stage 3 checkpoint missing"; exit 1; }

echo "== [6/7] RLMIL fine-tuning, stages 1-3 (murcl_tpu_torch/runs/finetune.sh) =="
finetune_stage 1 0.0001 0.00005
finetune_stage 2 0.0001 0.00005
finetune_stage 3 0.00005 0.00001
BEST=$(find "$WORK/runs/finetune" -path "*stage_3*" -name model_best.pth.tar | head -1)
[ -n "$BEST" ] || { echo "finetune stage 3 checkpoint missing"; exit 1; }

echo "== [7/7] attention heatmaps =="
python -m murcl_tpu_torch.create_heatmaps \
  --data_csv "$CSV" --coord_dir "$WORK/patches/coord" \
  --save_dir "$WORK/heatmaps" --checkpoint "$BEST" \
  --device "$DEVICE"

echo "DONE: runs in $WORK/runs, heatmaps in $WORK/heatmaps"
