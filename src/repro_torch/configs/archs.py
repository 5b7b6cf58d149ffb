"""Import side-effect module: registers all 10 assigned architectures."""
from repro_torch.configs.smollm_135m import SMOLLM_135M
from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B
from repro_torch.configs.yi_9b import YI_9B
from repro_torch.configs.command_r_plus_104b import COMMAND_R_PLUS_104B
from repro_torch.configs.mixtral_8x22b import MIXTRAL_8X22B
from repro_torch.configs.olmoe_1b_7b import OLMOE_1B_7B
from repro_torch.configs.mamba2_1_3b import MAMBA2_1_3B
from repro_torch.configs.zamba2_2_7b import ZAMBA2_2_7B
from repro_torch.configs.whisper_medium import WHISPER_MEDIUM
from repro_torch.configs.phi_3_vision_4_2b import PHI_3_VISION_4_2B

ALL_ARCHS = [
    SMOLLM_135M,
    QWEN2_1_5B,
    YI_9B,
    COMMAND_R_PLUS_104B,
    MIXTRAL_8X22B,
    OLMOE_1B_7B,
    MAMBA2_1_3B,
    ZAMBA2_2_7B,
    WHISPER_MEDIUM,
    PHI_3_VISION_4_2B,
]
