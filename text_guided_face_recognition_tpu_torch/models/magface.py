"""MagFace backbone.

Counterpart of `network_builder` in
text_guided_face_recognition_tpu/models/magface.py: the reference's
NetworkBuilder wraps an iresnet unchanged, so the frozen MagFace backbone
is the ArcFace iResNet (models/iresnet.py), returning (global, local); its
checkpoint differs only in its key prefix (engine/convert.convert_magface).
Only iresnet18, the shipped checkpoint's arch, is ported; the other archs
and the trainable surface (SoftmaxBuilder, MagLinear, mag_loss) are not
yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.models import iresnet

__all__ = ["network_builder"]


def network_builder(arch: str = "iresnet18", **kw) -> iresnet.IResNet:
    """The MagFace backbone: the iresnet `arch`, (global, local) out."""
    if arch != "iresnet18":
        raise NotImplementedError(
            f"MagFace arch {arch!r}: only iresnet18 is ported "
            "(ROADMAP.md, Queue 1)")
    return iresnet.iresnet18(**kw)
