"""Config registry of the PyTorch port.  Importing this package populates
the registry with the architectures the port serves so far."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    QuantConfig,
    SkipConfig,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs import llama2_7b  # noqa: F401
from repro_torch.configs import mamba2_2_7b  # noqa: F401
