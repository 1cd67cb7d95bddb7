"""DLRM, the survey's flagship SIMD workload (§4.3.1, Fig. 7): a deep
learning recommendation model whose embedding tables dominate memory
(80-95% of its weights) with almost no FLOPs [26, 31].

Not one of the assigned transformer architectures: it is here so the SIMD
quadrant's embedding inference runs on a faithful workload. The widths are
the reference's (Criteo-style: 26 sparse features, 13 dense ones).
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    num_tables: int = 26            # Criteo-style sparse features
    rows_per_table: int = 10_000_000  # production tables are 10M-100M rows
    embed_dim: int = 128
    num_dense_features: int = 13
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    multi_hot: int = 8              # lookups per table per query
    dtype: str = "float32"

    def embedding_params(self) -> int:
        return self.num_tables * self.rows_per_table * self.embed_dim

    def mlp_params(self) -> int:
        dims_b = (self.num_dense_features,) + self.bottom_mlp
        n = sum(a * b + b for a, b in zip(dims_b[:-1], dims_b[1:]))
        # pairwise interaction of (tables + 1) embed-dim vectors + bottom out
        num_int = (self.num_tables + 1) * self.num_tables // 2
        top_in = num_int + self.embed_dim
        dims_t = (top_in,) + self.top_mlp
        n += sum(a * b + b for a, b in zip(dims_t[:-1], dims_t[1:]))
        return n

    def param_count(self) -> int:
        return self.embedding_params() + self.mlp_params()


CONFIG = DLRMConfig()
