"""Per-architecture configs of the port (one module per architecture).

Importing this package registers every architecture; use
``repro_torch.configs.base.get_config(name)`` / ``list_archs()``.
"""
from repro_torch.configs import deepseek_coder_33b  # noqa: F401
from repro_torch.configs import deepseek_v3_671b  # noqa: F401
from repro_torch.configs import gemma2_27b  # noqa: F401
from repro_torch.configs import gemma3_4b  # noqa: F401
from repro_torch.configs import internvl2_76b  # noqa: F401
from repro_torch.configs import minitron_4b  # noqa: F401
from repro_torch.configs import moonshot_v1_16b_a3b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import seamless_m4t_medium  # noqa: F401
from repro_torch.configs import xlstm_1p3b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_archs,
)
