from dafne_torch.config.config import CfgNode, get_cfg

__all__ = ["CfgNode", "get_cfg"]
