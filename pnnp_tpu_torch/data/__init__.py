from pnnp_tpu_torch.data.io import dataload, pack_raw_np, load_info, save_info
from pnnp_tpu_torch.data.crops import CropPlanner
from pnnp_tpu_torch.data.datasets import (
    BaseRawDataset,
    SIDDataset,
    SynDataset,
    RawDataset,
    NFSynDataset,
    ProxyDataset,
    ELDDataset,
    MixDataset,
    PMNNPDataset,
    SFRNDataset,
    TestDataset,
    MultiDataset,
    DATASET_REGISTRY,
    build_dataset,
)
from pnnp_tpu_torch.data.loader import DataLoader, collate
