from text_guided_face_recognition_tpu_torch.data.datasets import (  # noqa: F401
    TestDataset,
    TrainDataset,
    load_class_id,
    load_filenames,
    load_text_data,
    load_text_data_bert,
)
from text_guided_face_recognition_tpu_torch.data.loader import DataLoader  # noqa: F401
from text_guided_face_recognition_tpu_torch.data.transforms import (  # noqa: F401
    eval_transform,
    train_transform,
)
