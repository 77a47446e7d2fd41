"""The paper's own target models, Table 6 (M1 / M2 / M3)."""
from repro_torch.configs.base import DLRMConfig, register

M1 = register(DLRMConfig(
    name="dlrm-m1",
    num_params=143_000_000_000,
    size_gb=143.0,
    num_user_tables=61,
    user_dim_bytes=(90, 172),   # avg 51 reported; we sample within [min,max]
    user_avg_pool=42,
    num_item_tables=30,
    item_dim_bytes=(90, 172),
    item_avg_pool=9,
    user_batch=1,
    item_batch=50,
    num_mlp_layers=31,
    avg_mlp_size=300,
    qps_target=120,
))

M2 = register(DLRMConfig(
    name="dlrm-m2",
    num_params=450_000_000_000,
    size_gb=150.0,
    num_user_tables=450,
    user_dim_bytes=(32, 288),
    user_avg_pool=25,
    num_item_tables=280,
    item_dim_bytes=(4, 320),
    item_avg_pool=14,
    user_batch=1,
    item_batch=150,
    num_mlp_layers=43,
    avg_mlp_size=735,
    qps_target=450,
))

M3 = register(DLRMConfig(
    name="dlrm-m3",
    num_params=5_000_000_000_000,
    size_gb=1000.0,
    num_user_tables=1800,
    user_dim_bytes=(32, 512),
    user_avg_pool=26,
    num_item_tables=900,
    item_dim_bytes=(32, 512),
    item_avg_pool=26,
    user_batch=1,
    item_batch=1000,
    num_mlp_layers=35,
    avg_mlp_size=6000,
    qps_target=3150,
))
