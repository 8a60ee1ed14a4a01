from neurecon_tpu_torch.ops.ray import (get_rays, get_rays_at, lift, lin2img,
                                        near_far_from_sphere)
from neurecon_tpu_torch.ops.sampling import sample_pdf, searchsorted

__all__ = ["get_rays", "get_rays_at", "lift", "lin2img", "near_far_from_sphere",
           "sample_pdf", "searchsorted"]
