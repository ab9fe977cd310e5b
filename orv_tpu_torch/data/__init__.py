from orv_tpu_torch.data.dataset import (
    CascadedRobotDataset,
    DatasetConfig,
    DemoRobotDataset,
    RobotDataset,
    collate_control,
)

__all__ = [
    "CascadedRobotDataset",
    "DatasetConfig",
    "DemoRobotDataset",
    "RobotDataset",
    "collate_control",
]
