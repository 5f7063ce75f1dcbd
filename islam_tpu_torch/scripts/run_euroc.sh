#!/bin/bash
# The euroc preset of scripts/run_euroc.sh on the port, on the card:
#   bash islam_tpu_torch/scripts/run_euroc.sh [SEQUENCE_DIR]
# Set DEVICE=cpu to run it on the CPU, SCAN_CHUNK=K for --scan-chunk K and
# BF16=1 for --bf16.

data_dir=${1:-data/euroc/MH_01_easy/mav0}

loss_weight='(4,0.1,2,0.1)'
lr=3e-6
batch_size=8
train_epoch=14

root_dir=train_results
train_name=$(date +"%Y%m%d_%H%M%S")_euroc

result_dir=$root_dir/$train_name
save_model_dir=$root_dir/$train_name/models
mkdir -p $result_dir $save_model_dir

python -m islam_tpu_torch.train \
    --result-dir $result_dir \
    --save-model-dir $save_model_dir \
    --vo-model-name models/stereo_flow_pose.pkl \
    --imu-denoise-model-name models/imudenoise.pkl \
    --batch-size $batch_size \
    --worker-num 2 \
    --data-root $data_dir \
    --data-type euroc \
    --start-frame 0 \
    --end-frame -1 \
    --train-epoch $train_epoch \
    --start-epoch 1 \
    --lr $lr \
    --loss-weight $loss_weight \
    --snapshot-interval 100 \
    --fix-model-parts flow stereo \
    --rot-w 1 --trans-w 0.1 \
    --device ${DEVICE:-cuda} \
    ${SCAN_CHUNK:+--scan-chunk $SCAN_CHUNK} ${BF16:+--bf16} \
    | tee $result_dir/log.txt
