#!/bin/sh
# Downstream finetune from a MuRCL-pretrained checkpoint,
# on the PyTorch/CUDA port: the flags of runs/finetune.sh (--device 0 is the
# card, cpu the plain CPU path). Run from anywhere:
#   sh murcl_tpu_torch/runs/finetune.sh
cd "$(dirname "$0")/../.."

echo "finetune via murcl_tpu_torch.train_RLMIL"
for STAGE in 1 2; do
  python -m murcl_tpu_torch.train_RLMIL \
    --dataset Camelyon16 \
    --data_csv path/to/data_csv.csv \
    --data_split_json path/to/data_split_json.json \
    --train_data train \
    --feat_size 1024 \
    --preload \
    --train_method finetune \
    --train_stage ${STAGE} \
    --checkpoint_pretrained path/to/pretrained/checkpoint/stage_3/model_best.pth.tar \
    --T 6 \
    --scheduler CosineAnnealingLR \
    --batch_size 1 \
    --epochs 40 \
    --backbone_lr 0.0001 \
    --fc_lr 0.00005 \
    --arch CLAM_SB \
    --device 0 \
    --save_model \
    --exist_ok
done
python -m murcl_tpu_torch.train_RLMIL \
  --dataset Camelyon16 \
  --data_csv path/to/data_csv.csv \
  --data_split_json path/to/data_split_json.json \
  --train_data train \
  --feat_size 1024 \
  --preload \
  --train_method finetune \
  --train_stage 3 \
  --T 6 \
  --scheduler CosineAnnealingLR \
  --batch_size 1 \
  --epochs 40 \
  --backbone_lr 0.00005 \
  --fc_lr 0.00001 \
  --arch CLAM_SB \
  --device 0 \
  --save_model \
  --exist_ok
