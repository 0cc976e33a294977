from vpt_tpu_torch.models.base import RENDERERS, make_renderer  # noqa: F401

# importing a renderer module registers it with the factory
from vpt_tpu_torch.models import dos, lao, mcm, mcm_spectral, mcs, raymarch  # noqa: F401
