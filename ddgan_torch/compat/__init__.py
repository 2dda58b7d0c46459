from .weights import load_netg_pth, state_dict_from_flax, strip_module_prefix  # noqa: F401
