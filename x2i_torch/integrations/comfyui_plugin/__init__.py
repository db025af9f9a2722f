"""ComfyUI plugin shim for the port's nodes (``x2i_torch.integrations.
comfyui``). Install by linking this directory into ComfyUI's custom nodes:

    ln -s /path/to/repo/x2i_torch/integrations/comfyui_plugin \
        ComfyUI/custom_nodes/comfyui_x2i_torch

ComfyUI imports each custom-node package by its path and reads
NODE_CLASS_MAPPINGS and NODE_DISPLAY_NAME_MAPPINGS; the shim puts the
repository on ``sys.path`` where ``x2i_torch`` is not installed.
"""

import os
import sys

_repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.realpath(__file__)))))

try:
    from x2i_torch.integrations.comfyui import (  # noqa: F401
        NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS)
except ImportError:
    if _repo_root not in sys.path:
        sys.path.insert(0, _repo_root)
    from x2i_torch.integrations.comfyui import (  # noqa: F401
        NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS)

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
