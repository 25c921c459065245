"""models of the PyTorch port (counterpart of cerebro_tpu.models)."""

from cerebro_tpu_torch.models.backbones import (  # noqa: F401
    MobileTrunk,
    SeparableBlock,
    VGGTrunk,
    normalize_image,
)
from cerebro_tpu_torch.models.descriptor import (  # noqa: F401
    DescriptorNet,
    convert_params,
    create_descriptor_model,
    describe_batch,
    export_params,
    load_descriptor_params,
)
from cerebro_tpu_torch.models.keypoints import (  # noqa: F401
    KeypointNet,
    create_keypoint_model,
    detect_keypoints,
    heatmap_from_logits,
    make_optimizer_state,
    match_image_pair_learned,
    synthetic_corner_batch,
)
from cerebro_tpu_torch.models.netvlad import GhostVLAD, NetVLAD  # noqa: F401
