from text_guided_face_recognition_tpu_torch.ops.attention import (  # noqa: F401
    damsm_similarity,
    func_attention,
)
from text_guided_face_recognition_tpu_torch.ops.block import (  # noqa: F401
    attn_block,
    attn_block_bwd,
    attn_block_ref,
    ffn_block,
    ffn_block_bwd,
    ffn_block_ref,
    tower_block,
    tower_block_bwd,
    tower_block_ref,
)
from text_guided_face_recognition_tpu_torch.ops.damsm import (  # noqa: F401
    damsm_similarity_cuda,
    damsm_similarity_fused,
)
from text_guided_face_recognition_tpu_torch.ops.images import (  # noqa: F401
    device_normalize,
)
from text_guided_face_recognition_tpu_torch.ops.layernorm import (  # noqa: F401
    layernorm_bwd,
    layernorm_fused,
    layernorm_ref,
)
from text_guided_face_recognition_tpu_torch.ops.losses import (  # noqa: F401
    clip_loss,
    clip_soft_loss,
    cmpc_loss,
    cmpm_loss,
    cosine_similarity,
    cross_entropy_rows,
    focal_loss,
    global_loss,
    kl_loss,
    sent_loss,
    words_loss,
)
from text_guided_face_recognition_tpu_torch.ops.margins import (  # noqa: F401
    arc_margin_logits,
    normalized_cosine,
)
from text_guided_face_recognition_tpu_torch.ops.philox import (  # noqa: F401
    attn_stream_bits,
    ffn_stream_bits,
    tower_stream_bits,
)
from text_guided_face_recognition_tpu_torch.ops.wra import (  # noqa: F401
    word_region_alignment_loss,
)
