from stable_virtual_camera_tpu_torch.data.parsers import (
    BaseParser,
    COLMAPParser,
    DirectParser,
    ReconfusionParser,
    get_parser,
)
from stable_virtual_camera_tpu_torch.data.dataset import Dataset

__all__ = [
    "BaseParser",
    "COLMAPParser",
    "DirectParser",
    "ReconfusionParser",
    "Dataset",
    "get_parser",
]
