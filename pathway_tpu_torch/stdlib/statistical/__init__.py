"""Statistical stdlib (reference: ``python/pathway/stdlib/statistical/``).

Carried from ``pathway_tpu/stdlib/statistical/__init__.py``.
"""

from pathway_tpu_torch.stdlib.statistical._interpolate import InterpolateMode, interpolate

__all__ = ["InterpolateMode", "interpolate"]
