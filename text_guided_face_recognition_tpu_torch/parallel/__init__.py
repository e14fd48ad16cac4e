"""Data parallelism over `torch.distributed` (one process a rank, launched by
torchrun): the process group (`mesh`), the differentiable collectives of the
step (`contrastive`), the explicit shard_map steps of both stages (`spmd`)
and the class-sharded margin classifier and its stage-2 step
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
    classifier_specs_for_state,
    gather_state_for_partial_fc,
    make_partial_fc_fusion_step,
    shard_state_for_partial_fc,
    sharded_margin_ce,
)
from text_guided_face_recognition_tpu_torch.parallel.spmd import (  # noqa: F401
    make_shardmap_fusion_step,
    make_shardmap_train_step,
)
