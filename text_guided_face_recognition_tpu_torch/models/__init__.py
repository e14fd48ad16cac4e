from text_guided_face_recognition_tpu_torch.models.fusion import (  # noqa: F401
    FCFM,
    ConcatAttention,
    LinearFusion,
    ParagraphLevelCFA,
    WordLevelCFA_LSTM,
)
from text_guided_face_recognition_tpu_torch.models.image_heads import (  # noqa: F401
    IMIM,
    ImageHeading,
)
from text_guided_face_recognition_tpu_torch.models.iresnet import (  # noqa: F401
    IResNet,
    iresnet18,
    iresnet34,
    iresnet50,
    iresnet100,
    iresnet200,
)
from text_guided_face_recognition_tpu_torch.models.irnet import (  # noqa: F401
    GDC,
    GNAP,
    IRBackbone,
    build_model,
)
from text_guided_face_recognition_tpu_torch.models.layers import (  # noqa: F401
    DotProductAttention,
    LayerNormCHW,
    MultiHeadAttention,
    PReLU,
    ProjectionHead,
    ScaledDotProductAttention,
    SelfAttention2D,
    TorchMultiheadAttention,
    l2_normalize,
)
from text_guided_face_recognition_tpu_torch.models.legacy_attention import (  # noqa: F401
    ChannelAttention,
    SpatialAttention,
)
from text_guided_face_recognition_tpu_torch.models.magface import (  # noqa: F401
    SoftmaxBuilder,
    mag_loss,
    network_builder,
)
from text_guided_face_recognition_tpu_torch.models.margins import (  # noqa: F401
    AdaFaceHead,
    AddMarginProduct,
    ArcMarginProduct,
    MagLinear,
    SphereProduct,
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
