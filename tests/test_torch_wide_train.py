"""Both trainers at head widths past 64, held to patent_tpu on the CPU.

The fine-tune and ``train_end`` train any ``VisionConfig`` in both
packages; the port's attention backward (row 13) and the f32 attention
(row 14′) take every head width that is a multiple of 8 up to 128.  Here
two steps of each trainer run at the 2-layer towers of head width 80 and
72 (the latter on the kernels' 80 instance) of
tests/test_torch_wide_heads.py, from the same seeded weights and batches
as JAX's with its Pallas kernels in interpret mode, and are held to JAX by
the checks and gates of tests/test_torch_finetune.py and
tests/test_torch_train_end.py, which make these steps at their own towers
(``two_steps_of``); JAX's fine-tune step is compiled without XLA's excess
precision here, as the train_end test compiles its own (the reason is
stated at ``two_steps_of``).  The CUDA kernels are held to the same plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import pytest
import torch

import test_torch_finetune as ft
import test_torch_train_end as te
from patent_tpu.models.vit import VisionConfig
from patent_tpu_torch.train import train_end as torch_te
from test_torch_wide_heads import TOWERS

WIDE = ["hd80", "hd72"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the host's cores: two intra-op threads
    each keep torch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=WIDE)
def finetune_steps(request):
    return ft.two_steps_of(VisionConfig(**TOWERS[request.param]),
                           excess_precision=False)


def test_finetune_two_steps_metrics_match_jax(finetune_steps):
    ft.test_two_steps_metrics_match_jax(finetune_steps)


def test_finetune_step_one_gradients_match_jax(finetune_steps):
    ft.test_step_one_gradients_match_jax(finetune_steps)


def test_finetune_updates_match_jax_and_frozen_leaves_stay(finetune_steps):
    ft.test_two_step_updates_match_jax_and_frozen_leaves_stay(finetune_steps)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wide_train_end"))
    _recs, images_dir, graph, pairs, implication = torch_te.synthetic_setup(
        path, 32)
    batches = list(torch_te.synthetic_batches(list(pairs), images_dir, graph,
                                              1, 8, 32))
    return path, graph, implication, batches


@pytest.fixture(scope="module", params=WIDE)
def train_end_steps(request, corpus):
    tower = VisionConfig(**TOWERS[request.param])
    assert tower.image_size == 32         # the corpus's pixels
    return te.two_steps_of(corpus, tower, 9)


def test_train_end_two_steps_metrics_match_jax(train_end_steps):
    te.test_two_steps_metrics_match_jax(train_end_steps)


def test_train_end_params_match_jax_and_frozen_leaves_stay(train_end_steps):
    te.test_two_steps_params_match_jax_and_frozen_leaves_stay(
        train_end_steps)
