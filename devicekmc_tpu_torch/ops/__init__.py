"""Tensor operations of the port: compaction, ELL products, CG, the device
loop of a captured graph (graph), and the hand-written CUDA kernels with
their plain versions."""
