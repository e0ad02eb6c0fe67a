#!/usr/bin/env bash
# Multi-process survey launcher for the PyTorch port: the twin of
# scripts/launch_survey.sh, itself the replacement of the reference's SLURM
# job-array pattern (reference: slurm/submit_gp_find_lls.sh:7-13).
#
# One process per GPU; each processes its contiguous shard of the spectrum
# list on its card and writes processed_qsos.shardNNNN.h5; merge with
#   python -c "import glob; from gpy_dla_detection_tpu_torch.analysis.catalog_tools import \
#              merge_catalogs; merge_catalogs(sorted(glob.glob('processed_qsos.shard*.h5')), 'processed_qsos.h5')"
#
# Usage (one per card; the card is CUDA_VISIBLE_DEVICES' first):
#   GPY_DLA_NUM_PROCESSES=<n> GPY_DLA_PROCESS_ID=<i> CUDA_VISIBLE_DEVICES=<i> \
#   ./scripts/launch_survey_torch.sh file_list z_qso_list.txt [run_bayes_select options]
set -euo pipefail

FILE_LIST=${1:?usage: launch_survey_torch.sh file_list z_list}
Z_LIST=${2:?usage: launch_survey_torch.sh file_list z_list}

NUM=${GPY_DLA_NUM_PROCESSES:-1}
PID=${GPY_DLA_PROCESS_ID:-0}

TOTAL=$(wc -l < "$FILE_LIST")
PER=$(( (TOTAL + NUM - 1) / NUM ))
START=$(( PID * PER + 1 ))
END=$(( START + PER - 1 ))

mapfile -t FILES < <(sed -n "${START},${END}p" "$FILE_LIST")
mapfile -t ZS < <(sed -n "${START},${END}p" "$Z_LIST")

echo "[process ${PID}/${NUM}] processing ${#FILES[@]} spectra (${START}..${END})"

python -m gpy_dla_detection_tpu_torch.run_bayes_select \
    --qso_list "${FILES[@]}" \
    --z_qso_list "${ZS[@]}" \
    --output "processed_qsos.shard$(printf '%04d' "$PID").h5" \
    --checkpoint \
    "${@:3}"
