"""Plain-JAX numerical kernels.

kernels.reduce — a scatter-free sorted-COO segment reduction (ReducePlan)
for fixed-topology assembly; whether it still beats scatter-add /
segment_sum on the GPU is ROADMAP C3.
"""
