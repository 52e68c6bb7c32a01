#!/bin/bash
# End-to-end FFM learning-quality gate, mirroring the reference's CI test
# (examples/ffm/run_fw_with_prediction_tests.sh): train LR+FFM on the
# herbivore/carnivore data, convert to inference weights, check
# (a) inference == full-weight predictions, (b) predictions non-degenerate,
# (c) balanced accuracy on test-hard > 0.80.
set -e
cd "$(dirname "$0")/.."
D=/tmp/ffm_verify/datasets
O=/tmp/ffm_verify
mkdir -p "$O"
if [ ! -f "$D/train.vw" ]; then
    python examples/ffm/generate.py --out "$D" \
        --num_animals 300 --num_foods 200 --num_train_examples 30000
fi
NS="--keep A --keep B --interactions AB --ffm_k 10 --ffm_field A --ffm_field B"
REST="-l 0.1 -b 25 --sgd --loss_function logistic --link logistic --power_t 0.0 --l2 0.0 --hash all --noconstant --fwt_platform cpu --fwt_batch_size 256"

python -m fwumious_wabbit_tpu $NS $REST --data $D/train.vw -p $O/training.txt -f $O/full.fwt --save_resume
python -m fwumious_wabbit_tpu $NS $REST -i $O/full.fwt --convert_inference_regressor $O/inference.fwt
python -m fwumious_wabbit_tpu $NS $REST -i $O/full.fwt --data $D/test-hard.vw -p $O/hard_full.txt -t
python -m fwumious_wabbit_tpu $NS $REST -i $O/inference.fwt --data $D/test-hard.vw -p $O/hard_inf.txt -t

python - <<'EOF'
full = [float(x) for x in open('/tmp/ffm_verify/hard_full.txt')]
inf  = [float(x) for x in open('/tmp/ffm_verify/hard_inf.txt')]
labels = [1 if l.split()[0]=='1' else 0 for l in open('/tmp/ffm_verify/datasets/test-hard.vw')]
assert len(full) == len(labels), (len(full), len(labels))
same = sum(1 for a,b in zip(full,inf) if abs(a-b) < 1e-9)
print(f"inference==full: {same}/{len(full)}")
uniq = len(set(full))
print(f"unique predictions: {uniq}")
tp = sum(1 for p,y in zip(full,labels) if y==1 and p>=0.5)
tn = sum(1 for p,y in zip(full,labels) if y==0 and p<0.5)
pos = sum(labels); neg = len(labels)-pos
ba = 0.5*(tp/max(pos,1) + tn/max(neg,1))
print(f"hard-test balanced accuracy: {ba:.4f} (gate: >0.80)")
assert same == len(full)
assert uniq > 1
assert ba > 0.80, ba
print("FFM GATE PASSED")
EOF
