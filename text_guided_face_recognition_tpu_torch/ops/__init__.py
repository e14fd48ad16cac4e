from text_guided_face_recognition_tpu_torch.ops.block import (  # noqa: F401
    attn_block,
    attn_block_ref,
    ffn_block,
    ffn_block_ref,
)
from text_guided_face_recognition_tpu_torch.ops.images import (  # noqa: F401
    device_normalize,
)
from text_guided_face_recognition_tpu_torch.ops.layernorm import (  # noqa: F401
    layernorm_fused,
    layernorm_ref,
)
