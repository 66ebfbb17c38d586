"""Per-architecture configs of the port (one module per architecture).

Importing this package registers every architecture; use
``repro_torch.configs.base.get_config(name)`` / ``list_archs()``.
"""
from repro_torch.configs import gemma2_27b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_archs,
)
