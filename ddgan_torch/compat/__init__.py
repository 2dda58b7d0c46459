from .msgpack import read_msgpack, write_msgpack  # noqa: F401
from .weights import (  # noqa: F401
    flax_tree_from_port, flax_trees_from_port, load_netg_ckpt, load_netg_pth,
    state_dict_from_flax, strip_module_prefix,
)
