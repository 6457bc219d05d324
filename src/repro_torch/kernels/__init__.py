# Hand-written CUDA kernels (sm_90a) for the data hot spots, the port of the
# Pallas TPU kernels of repro/kernels/:
#   groupby_agg     — columnar group-by aggregation (the paper's
#                     usd_by_country hot spot) and the combine of per-shard
#                     states; csrc/groupby_agg.cu
#   filter_compact  — predicate compaction (the paper's euro_selection hot
#                     spot; block counts + fused ballot compaction);
#                     csrc/filter_compact.cu
# build.py = nvcc at first use into build/repro_torch/, loaded with ctypes;
# ops.py = public wrappers (device routing, launch counts);
# ref.py = plain PyTorch versions (the CPU path and the correctness contract).
# flash attention is not ported yet (ROADMAP.md, Queue 2).
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
