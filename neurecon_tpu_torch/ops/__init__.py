from neurecon_tpu_torch.ops.fused_mlp import fused_sdf_forward
from neurecon_tpu_torch.ops.ray import (get_dvals_from_radius, get_rays, get_rays_at,
                                        get_sphere_intersection, lift, lin2img,
                                        near_far_from_sphere)
from neurecon_tpu_torch.ops.sampling import (linspace01, sample_cdf, sample_pdf,
                                             searchsorted)

__all__ = ["fused_sdf_forward", "get_dvals_from_radius", "get_rays", "get_rays_at",
           "get_sphere_intersection", "lift", "lin2img", "near_far_from_sphere", "linspace01", "sample_cdf", "sample_pdf",
           "searchsorted"]
