from ilswiss_tpu_torch.launchers.variant import (
    build_variants, check_exp_spec_format, flatten_dict, unflatten_dict,
)
