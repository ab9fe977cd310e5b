from orv_tpu_torch.data.dataset import (
    BucketSampler,
    CascadedRobotDataset,
    DatasetConfig,
    DemoRobotDataset,
    MultiViewRobotDataset,
    RobotDataset,
    collate_control,
)

__all__ = [
    "BucketSampler",
    "CascadedRobotDataset",
    "DatasetConfig",
    "DemoRobotDataset",
    "MultiViewRobotDataset",
    "RobotDataset",
    "collate_control",
]
