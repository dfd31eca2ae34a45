"""Vision tower builder: the name-sniffing dispatch (port of
``spatialrgpt_tpu/models/tower_builder.py``).

Chooses the tower family from the model name (intern / radio / clip /
siglip), honours the S² multi-scale flag and reports ``mm_hidden_size``
back to the composite config.  The handle holds the family's config; the
weights come from ``utils/weights.py`` (``init_random_{clip,intern_vit,
radio}`` or the ``load_*_from_jax`` loaders, SigLIP's through the
composite), and the features from the family's ``forward_features``
(RADIO: ``RadioVisionTower``), through ``models/s2.py::
multiscale_forward`` with ``use_s2``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from spatialrgpt_tpu_torch.config import SiglipVisionConfig


@dataclass
class TowerHandle:
    family: str  # siglip | clip | intern | radio
    config: object
    forward: Optional[Callable] = None  # params-bound callable when loaded
    use_s2: bool = False
    s2_scales: Tuple[int, ...] = ()
    mm_hidden_size: int = 0


def build_vision_tower(
    name: str,
    use_s2: bool = False,
    s2_scales: str = "336,672,1008",
    select_layer: int = -2,
    select_feature: str = "cls_patch",
) -> TowerHandle:
    lname = name.lower()
    scales = tuple(int(s) for s in s2_scales.split(",")) if use_s2 else ()

    if "intern" in lname:
        from spatialrgpt_tpu_torch.models.intern_vit import InternVisionConfig

        cfg = InternVisionConfig(select_layer=select_layer, select_feature="patch")
        return TowerHandle("intern", cfg, use_s2=use_s2, s2_scales=scales, mm_hidden_size=cfg.hidden_size)

    if lname.startswith("radio") or "radio" in lname:
        from spatialrgpt_tpu_torch.models.radio import parse_radio_spec

        spec = parse_radio_spec(name if name.startswith("radio:") else f"radio:768:{name}:")
        return TowerHandle("radio", spec, use_s2=False, mm_hidden_size=1280)

    if "clip" in lname:
        cfg = SiglipVisionConfig(
            hidden_size=1024,
            intermediate_size=4096,
            num_hidden_layers=24,
            num_attention_heads=16,
            image_size=336,
            patch_size=14,
            select_layer=select_layer,
            select_feature="patch",
        )
        mm = cfg.hidden_size * (len(scales) if use_s2 else 1)
        return TowerHandle("clip", cfg, use_s2=use_s2, s2_scales=scales, mm_hidden_size=mm)

    # default: siglip (the reference's default tower)
    cfg = SiglipVisionConfig(select_layer=select_layer, select_feature=select_feature)
    mm = cfg.hidden_size * (len(scales) if use_s2 else 1)
    return TowerHandle("siglip", cfg, use_s2=use_s2, s2_scales=scales, mm_hidden_size=mm)
