"""Data parallelism over `torch.distributed` (one process a rank, launched by
torchrun): the process group (`mesh`), the differentiable collectives of the
step (`contrastive`) and the class-sharded margin classifier
(`partial_fc`)."""

from text_guided_face_recognition_tpu_torch.parallel.contrastive import (  # noqa: F401
    gather_global_negatives,
    gather_rows_summed,
    local_diag_labels,
    psum,
    psum_mean,
    sync_sum,
)
from text_guided_face_recognition_tpu_torch.parallel.partial_fc import (  # noqa: F401
    sharded_margin_ce,
)
