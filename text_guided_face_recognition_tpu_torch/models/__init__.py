from text_guided_face_recognition_tpu_torch.models.fusion import (  # noqa: F401
    FCFM,
    LinearFusion,
    WordLevelCFA_LSTM,
)
from text_guided_face_recognition_tpu_torch.models.image_heads import (  # noqa: F401
    IMIM,
    ImageHeading,
)
from text_guided_face_recognition_tpu_torch.models.iresnet import (  # noqa: F401
    IResNet,
    iresnet18,
)
from text_guided_face_recognition_tpu_torch.models.irnet import (  # noqa: F401
    IRBackbone,
    build_model,
)
from text_guided_face_recognition_tpu_torch.models.layers import (  # noqa: F401
    LayerNormCHW,
    PReLU,
    ProjectionHead,
    SelfAttention2D,
    l2_normalize,
)
from text_guided_face_recognition_tpu_torch.models.margins import (  # noqa: F401
    ArcMarginProduct,
)
from text_guided_face_recognition_tpu_torch.models.text_rnn import (  # noqa: F401
    RNNEncoder,
)
from text_guided_face_recognition_tpu_torch.models.text_bert import (  # noqa: F401
    TEXT_ARCHS,
    BertWordMapping,
    TextArch,
    TextEncoder,
    TextHeading,
    TransformerEncoder,
)
