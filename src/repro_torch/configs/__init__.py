from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    PAPER_ARCHS,
    InputShape,
    ModelConfig,
    get_config,
    jax_routing,
    list_configs,
    reduce_config,
    register,
)
