"""Stage-2 fusion training on top of stage-1 LSTM or GRU encoders.

  python -m text_guided_face_recognition_tpu_torch.cli.fusion_lstm \
      [--cfg cfg/fusion_lstm.yml] [--synthetic] [--cpu] [--max_steps N] \
      [--max_epoch N]

Counterpart of src/fusion_lstm.py: fusion_bert's entry point under
cfg/fusion_lstm.yml. Runs on the CUDA card unless `--cpu` is given. A
config with fusion_type fcfm (WordLevelCFA_LSTM, en_type LSTM) needs
fusion_final_dim 768, the width of its output.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import fusion_bert


def main(argv=None):
    return fusion_bert.main(argv, "fusion_lstm.yml")


if __name__ == "__main__":
    main()
