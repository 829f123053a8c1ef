"""The port's ``ParamLayout`` (``repro_torch/core/param_layout.py``) against
the reference's (``repro/core/param_layout.py``): the same chunk bounds,
per-chunk keep and residual fractions, names and ``describe()`` for the
paper CNN and a reduced one over several chunk sizes and every override
form, the flat test, and the constructor's refusals."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core.param_layout import ParamLayout as JLayout  # noqa: E402
from repro.core.param_layout import leaf_sizes as j_leaf_sizes  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import ParamLayout  # noqa: E402
from repro_torch.core.param_layout import leaf_sizes  # noqa: E402
from repro_torch.models.cnn import cnn_template  # noqa: E402

WIDTHS = {"paper": {}, "small": dict(conv_filters=(8, 8), hidden=16)}
OVERRIDES = [None, {"conv": 0.5, "out": 0.5}, {"out": (0.5, 0.75)},
             {"dense_b": {"keep_frac": 0.3}, "conv2": {"residual_frac": 0.5}},
             {"w": 0.4}]


def _templates(width):
    jt = jax.eval_shape(lambda: j_init_cnn(JCNN(**WIDTHS[width]),
                                           jax.random.PRNGKey(0)))
    return cnn_template(CNNConfig(**WIDTHS[width])), jt


def _same(t, j):
    assert (t.n, t.bounds, t.keep_frac, t.residual_frac, t.names) == \
        (j.n, j.bounds, j.keep_frac, j.residual_frac, j.names)
    assert t.describe() == j.describe()
    assert (t.num_chunks, t.sizes, t.max_chunk, t.is_flat) == \
        (j.num_chunks, j.sizes, j.max_chunk, j.is_flat)
    assert repr(t) == repr(j)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_leaf_sizes_are_the_references(width):
    tt, jt = _templates(width)
    assert leaf_sizes(tt) == j_leaf_sizes(jt)


@pytest.mark.parametrize("overrides", OVERRIDES,
                         ids=["none", "float", "pair", "dict", "broad"])
@pytest.mark.parametrize("chunk_size", [700, 4096, 1_000_000, 10**8])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_layout_is_the_references(width, chunk_size, overrides):
    tt, jt = _templates(width)
    t = ParamLayout.from_template(tt, chunk_size, overrides=overrides)
    j = JLayout.from_template(jt, chunk_size, overrides=overrides)
    _same(t, j)


def test_paper_cnn_plan_at_a_million():
    """The slice's full-width layout: 9 chunks with the conv and out
    overrides, 8 without."""
    tt, _ = _templates("paper")
    t = ParamLayout.from_template(tt, 1_000_000,
                                  overrides={"conv": 0.5, "out": 0.5})
    assert t.sizes == (99_072, 256) + (1_000_000,) * 5 + (111_808, 2_313)
    assert t.keep_frac == (0.5,) + (None,) * 7 + (0.5,)
    assert t.names[0] == "conv1_b+conv1_w+conv2_b+conv2_w"
    assert ParamLayout.from_template(tt, 1_000_000).num_chunks == 8


def test_flat_layouts():
    assert ParamLayout.flat(10).is_flat
    assert ParamLayout.flat(10).bounds == JLayout.flat(10).bounds == \
        ((0, 10),)
    tt, _ = _templates("small")
    n = sum(int(np.prod(v.shape)) for v in tt.values())
    assert ParamLayout.from_template(tt, n).is_flat
    assert not ParamLayout.from_template(tt, n, overrides={"out": 0.5}
                                         ).is_flat
    assert not ParamLayout.from_template(tt, n - 1).is_flat


@pytest.mark.parametrize("cls", [ParamLayout, JLayout])
def test_constructor_refusals(cls):
    with pytest.raises(ValueError, match="at least one chunk"):
        cls(n=4, bounds=())
    with pytest.raises(ValueError, match="contiguous"):
        cls(n=4, bounds=((0, 2), (3, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        cls(n=4, bounds=((0, 2), (2, 2), (2, 4)))
    with pytest.raises(ValueError, match="n=5"):
        cls(n=5, bounds=((0, 4),))
    with pytest.raises(ValueError, match="num_chunks"):
        cls(n=4, bounds=((0, 2), (2, 4)), keep_frac=(0.5,))
    with pytest.raises(ValueError, match="chunk_size must be positive"):
        cls.from_template(_templates("small")[0 if cls is ParamLayout
                                              else 1], 0)
