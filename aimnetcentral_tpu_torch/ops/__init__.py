from aimnetcentral_tpu_torch.ops.math import (  # noqa: F401
    calc_distances,
    cosine_cutoff,
    exp_cutoff,
    exp_expand,
    nse,
    smoothstep,
)
from aimnetcentral_tpu_torch.ops.nb import (  # noqa: F401
    expand_mol,
    gather_nb,
    mask_pad_atoms,
    mol_sum,
    pair_mask,
)
