#!/bin/sh
# MuRCL self-supervised pretraining, 3-stage schedule,
# on the PyTorch/CUDA port: the flags of runs/pretrain.sh (--device 0 is the
# card, cpu the plain CPU path). Run from anywhere:
#   sh murcl_tpu_torch/runs/pretrain.sh
cd "$(dirname "$0")/../.."

echo "pre-training via murcl_tpu_torch.train_MuRCL"
for STAGE in 1 2; do
  python -m murcl_tpu_torch.train_MuRCL \
    --dataset Camelyon16 \
    --data_csv path/to/data_csv.csv \
    --data_split_json path/to/data_split_json.json \
    --feat_size 1024 \
    --preload \
    --train_stage ${STAGE} \
    --T 6 \
    --scheduler CosineAnnealingLR \
    --batch_size 128 \
    --epochs 100 \
    --backbone_lr 0.0001 \
    --fc_lr 0.00005 \
    --patience 10 \
    --arch CLAM_SB \
    --device 0 \
    --exist_ok
done
python -m murcl_tpu_torch.train_MuRCL \
  --dataset Camelyon16 \
  --data_csv path/to/data_csv.csv \
  --data_split_json path/to/data_split_json.json \
  --feat_size 1024 \
  --preload \
  --train_stage 3 \
  --T 6 \
  --scheduler CosineAnnealingLR \
  --batch_size 128 \
  --epochs 100 \
  --backbone_lr 0.00005 \
  --fc_lr 0.00001 \
  --patience 10 \
  --arch CLAM_SB \
  --device 0 \
  --exist_ok
