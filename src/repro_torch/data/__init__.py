"""Data, port of ``repro.data``: the synthetic clustering sets
(``synthetic``) and the token pipeline (``tokens``)."""
from repro_torch.data.tokens import PipelineConfig, TokenPipeline  # noqa: F401
