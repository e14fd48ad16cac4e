"""Stage-1 FCAM pretraining with a bidirectional LSTM or GRU text encoder.

  python -m text_guided_face_recognition_tpu_torch.cli.train_encoders_lstm \
      [--cfg cfg/train_lstm.yml] [--synthetic] [--cpu] [--max_steps N] \
      [--max_epoch N] [--use_pallas]

Counterpart of src/train_encoders_lstm.py: train_encoders_bert's entry
point under cfg/train_lstm.yml, whose en_type picks the LSTM or the GRU.
Runs on the CUDA card unless `--cpu` is given.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import train_encoders_bert


def main(argv=None):
    return train_encoders_bert.main(argv, "train_lstm.yml",
                                    "Train LSTM Encoder")


if __name__ == "__main__":
    main()
