"""The transport superstep as one captured graph with the bf16 inner operator
(on-the-fly metal block): the engine's capture, the graph's body against the
eager engine bit for bit and against the JAX package's jitted superstep
(``torch_transport_graph`` holds the configurations)."""

import pytest
import torch

from torch_transport_graph import (bit_cases, check_bit_for_bit, check_engine_runs_on_the_graph,
                                   check_matches_jax)

torch.set_num_threads(1)

#: this file's configurations (the bf16 inner operator)
GROUP = ["bf16"]


@pytest.mark.parametrize("config", GROUP)
def test_engine_runs_the_new_configurations_on_the_graph(tmp_path, config):
    """The configuration runs on SuperstepGraph, per step and in batches
    (torch_transport_graph.check_engine_runs_on_the_graph)."""
    check_engine_runs_on_the_graph(tmp_path, config)


@pytest.mark.parametrize("config,skip,incremental", bit_cases(GROUP))
def test_transport_graph_matches_eager_bit_for_bit(tmp_path, config, skip, incremental):
    """The graph against the eager engine bit for bit, step for step
    (torch_transport_graph.check_bit_for_bit)."""
    check_bit_for_bit(tmp_path, config, skip, incremental)


@pytest.mark.parametrize("config", GROUP)
def test_transport_graph_matches_jax(tmp_path, config):
    """The graph against the JAX package's jitted superstep
    (torch_transport_graph.check_matches_jax)."""
    check_matches_jax(tmp_path, config)
