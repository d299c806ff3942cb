"""Sort-key encoding and the sort strategies, auron_tpu_torch against
auron_tpu on the same seeded columns: the words and bit claims of each key
type, the permutations of `lexsort_indices` under each strategy, and the
pack-sort's pass plan.  The JAX package's words are uint32/uint64; the
port holds a u32 word as its value and a u64 word as `w ^ 2^63` in int64,
so the JAX words are mapped to that form and compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from auron_tpu.columnar.batch import DeviceColumn as JCol
from auron_tpu.config import conf as jconf
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ops import radix_sort as JR
from auron_tpu.ops import sort_keys as JK
from auron_tpu.ops import strategy as JS
from auron_tpu_torch.columnar.batch import DeviceColumn
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir.schema import DataType, TypeId
from auron_tpu_torch.ops import radix_sort as R
from auron_tpu_torch.ops import sort_keys as SK
from auron_tpu_torch.ops import strategy as S

TYPES = {
    "bool": (TypeId.BOOL, np.bool_),
    "int8": (TypeId.INT8, np.int8),
    "int16": (TypeId.INT16, np.int16),
    "int32": (TypeId.INT32, np.int32),
    "date32": (TypeId.DATE32, np.int32),
    "int64": (TypeId.INT64, np.int64),
    "timestamp": (TypeId.TIMESTAMP_US, np.int64),
    "float64": (TypeId.FLOAT64, np.float64),
}


def _values(name, n, rng):
    tid, np_dt = TYPES[name]
    if name == "bool":
        return rng.random(n) < 0.5
    if name == "float64":
        # no -0.0 and no NaN with its sign bit set: there the engines
        # differ on purpose (test_float_order_is_sparks)
        v = rng.normal(0, 1e3, n)
        v[::7] = np.round(v[::7]) + 0.0          # ties, no -0.0
        special = np.array([np.inf, -np.inf, np.nan, 0.0, 5e-324, -1e300,
                            np.finfo(np.float64).max])
        v[:len(special)] = special
        return v
    info = np.iinfo(np_dt)
    v = rng.integers(info.min, info.max, n, dtype=np_dt, endpoint=True)
    v[:2] = [info.min, info.max]
    v[5::9] = v[4::9][:len(v[5::9])]            # ties
    return v


def _columns(name, n=300, seed=0):
    rng = np.random.default_rng(seed)
    vals = _values(name, n, rng)
    valid = rng.random(n) >= 0.15
    vals = np.where(valid, vals, np.zeros((), vals.dtype))
    tid = TYPES[name][0]
    port = DeviceColumn(DataType(tid), torch.from_numpy(vals.copy()),
                        torch.from_numpy(valid.copy()))
    jax = JCol(JDT(tid), jnp.asarray(vals), jnp.asarray(valid))
    return port, jax


def _as_port_word(w):
    """A JAX word in the port's int64 form."""
    a = np.asarray(w)
    if a.dtype == np.uint64:
        return (a ^ np.uint64(1 << 63)).view(np.int64)
    assert a.dtype == np.uint32, a.dtype
    return a.astype(np.int64)


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("name", sorted(TYPES))
def test_words_match_jax(name, asc, nulls_first):
    port, jax = _columns(name)
    got = SK.encode_key_column(port, asc, nulls_first)
    exp = JK.encode_key_column(jax, asc, nulls_first)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), _as_port_word(e))
    assert SK.encode_key_column_bits(port) == JK.encode_key_column_bits(jax)


@pytest.mark.parametrize("name", sorted(TYPES))
def test_words_order_the_values(name):
    """Ascending words order rows as numpy orders their values (nulls
    first), and stay inside their claimed bits."""
    port, _ = _columns(name, seed=3)
    null_rank, w = SK.encode_key_column(port, True, True)
    bits = SK.encode_key_column_bits(port)[1]
    v = port.validity.numpy()
    vals = port.data.numpy()[v]
    order = np.lexsort((w.numpy()[v],))
    sorted_vals = vals[order]
    if name == "float64":           # NaN sorts after every number
        nan = np.isnan(sorted_vals)
        assert nan.any() and nan[np.argmax(nan):].all()
        sorted_vals = sorted_vals[~nan]
    assert np.all(sorted_vals[:-1] <= sorted_vals[1:])
    assert set(null_rank.numpy()[~port.validity.numpy()]) <= {0}
    if bits <= 32:
        for asc in (True, False):
            ww = SK.encode_key_column(port, asc, True)[1].numpy()
            assert ww.min() >= 0 and ww.max() < (1 << 32)


def _key_set(seed, n=700):
    """A two-type key set with many ties and nulls: (port cols, jax cols,
    orders)."""
    names = ("int32", "float64", "int64")
    cols = [_columns(nm, n, seed + i) for i, nm in enumerate(names)]
    port = [c[0] for c in cols]
    for c in port:                       # coarse values: ties across keys
        c.data[:] = torch.where(
            c.validity, c.data % 5 if c.dtype.id != TypeId.FLOAT64 else
            torch.round(torch.nan_to_num(c.data, nan=1.0) / 500) + 0.0, 0)
    jax = [JCol(JDT(c.dtype.id), jnp.asarray(c.data.numpy()),
                jnp.asarray(c.validity.numpy())) for c in port]
    orders = [(True, True), (False, False), (True, False)]
    return port, jax, orders


@pytest.mark.parametrize("multipass", ["on", "off"])
@pytest.mark.parametrize("strategy", ["radix", "argsort"])
@pytest.mark.parametrize("num_rows", [700, 513])
def test_lexsort_permutation_matches_jax(strategy, multipass, num_rows):
    """The port's one argsort form (composed argsorts) against both of the
    JAX package's forms, multipass and its one multi-key lexsort."""
    port, jax, orders = _key_set(seed=num_rows)
    kv = {"auron.kernel.sort.strategy": strategy}
    cap = 1024      # rows past 700 are padding, rows past num_rows not live
    padded = [DeviceColumn(c.dtype,
                           torch.nn.functional.pad(c.data, (0, cap - 700)),
                           torch.nn.functional.pad(c.validity, (0, cap - 700)))
              for c in port]
    pw = SK.encode_sort_keys(padded, orders)
    jw = JK.encode_sort_keys([JCol(j.dtype, jnp.asarray(c.data.numpy()),
                                   jnp.asarray(c.validity.numpy()))
                              for j, c in zip(jax, padded)], orders)
    with conf.scoped(kv), \
            jconf.scoped({**kv, "auron.sort.multipass.enable": multipass}):
        got = SK.lexsort_indices(pw, num_rows, cap,
                                 SK.encode_sort_keys_bits(port))
        exp = JK.lexsort_indices(jw, num_rows, cap,
                                 JK.encode_sort_keys_bits(jax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # and both are numpy's stable lexsort of the words, padding last
    live = np.arange(cap) < num_rows
    ref = np.lexsort(tuple(w.numpy() for w in reversed(pw)) + (~live,))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("strategy,capacity,cpu_form,cuda_form", [
    ("radix", 1024, "radix", "radix"),
    ("argsort", 1 << 20, "multipass", "multipass"),
    ("auto", 1024, "multipass", "multipass"),
    ("auto", 1 << 20, "radix", "multipass")])
def test_sort_form_names_the_resolved_strategy(strategy, capacity,
                                               cpu_form, cuda_form):
    with conf.scoped({"auron.kernel.sort.strategy": strategy}):
        assert SK.sort_form(capacity, 4, "cpu") == cpu_form
        assert SK.sort_form(capacity, 4, "cuda") == cuda_form


@pytest.mark.parametrize("with_live", [False, True])
@pytest.mark.parametrize("bits", [[1, 64], [1, 32, 1, 64], [1, 1, 1, 32],
                                  [1, 64, 1, 32, 1, 64], [64, 64, 64]])
@pytest.mark.parametrize("capacity", [1024, 1 << 20, 1 << 31])
def test_pass_plan_matches_jax(bits, capacity, with_live):
    budget = 64 - R.ceil_log2(capacity)
    bs = ([1] if with_live else []) + bits
    port_units = R._units([torch.zeros(4, dtype=torch.int64)] * len(bs), bs,
                          budget)
    jax_units = JR._units([jnp.zeros(4, jnp.uint64)] * len(bs), bs, budget)
    assert [b for _, b in port_units] == [b for _, b in jax_units]
    got = [[b for _, b in p] for p in R._plan_passes(port_units, budget)]
    exp = [[b for _, b in p] for p in JR._plan_passes(jax_units, budget)]
    assert got == exp
    assert len(got) == JR.num_passes(bits, capacity, with_live)


@pytest.mark.parametrize("mode", ["auto", "radix", "argsort"])
@pytest.mark.parametrize("capacity", [1024, 1 << 15, 1 << 20])
@pytest.mark.parametrize("n_words", [1, 4])
def test_sort_strategy_resolves_like_jax(mode, capacity, n_words):
    """On the CPU the port resolves like the JAX CPU backend; on the card
    like the JAX 'gpu' backend, whose 'auto' is argsort."""
    with conf.scoped({"auron.kernel.sort.strategy": mode}), \
            jconf.scoped({"auron.kernel.sort.strategy": mode}):
        assert S.sort_strategy(capacity, n_words, "cpu") == \
            JS.sort_strategy(capacity, n_words)
        assert S.sort_strategy(capacity, n_words, "cuda") == \
            (mode if mode != "auto" else "argsort")


def test_float_order_is_sparks():
    """Reference fault (ROADMAP Queue 3): the JAX encoder sorts a NaN with
    its sign bit set before -inf and -0.0 strictly before 0.0.  Spark and
    the pyarrow oracle put every NaN last and keep -0.0 and 0.0 in input
    order (they compare equal); so does the port."""
    neg_nan = np.array([0xFFF8000000000000], np.uint64).view(np.float64)[0]
    vals = np.array([0.0, neg_nan, 1.0, -0.0, -np.inf, np.nan, -1.0])
    valid = np.ones(len(vals), bool)
    port = DeviceColumn(DataType.float64(), torch.from_numpy(vals.copy()),
                        torch.from_numpy(valid))
    jax = JCol(JDT.float64(), jnp.asarray(vals), jnp.asarray(valid))
    got = SK.lexsort_indices(SK.encode_key_column(port), len(vals),
                             len(vals)).numpy()
    ref = np.asarray(JK.lexsort_indices(JK.encode_key_column(jax),
                                        len(vals), len(vals)))
    oracle = pc.sort_indices(pa.array(vals),
                             sort_keys=[("", "ascending")]).to_numpy()
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, [4, 6, 0, 3, 2, 1, 5])
    np.testing.assert_array_equal(ref, [1, 4, 6, 3, 0, 2, 5])
