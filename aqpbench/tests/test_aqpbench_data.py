"""The table generator: reproducible from the seed, TPC-H's formulas."""
import numpy as np
import torch

from aqpbench.data import lineitem

CFG = {"scale_factor": 0.01, "rows_per_sf": 6_000_000,
       "parts_per_sf": 200_000, "groups": 4}


def test_retail_price_formula():
    # P_RETAILPRICE of partkeys 1, 10 and 1999 (spec 4.2.3): 901.00,
    # 910.01 and 1900.99 (90000 + 199 + 99900 cents).
    pk = np.asarray([1, 10, 1999])
    assert lineitem.retail_cents(pk).tolist() == [90100, 91001, 190099]


def test_same_seed_same_table():
    a, oa = lineitem.make_table(CFG, 2**31 + 5, "cpu")
    b, ob = lineitem.make_table(CFG, 2**31 + 5, "cpu")
    c, oc = lineitem.make_table(CFG, 2**31 + 6, "cpu")
    assert torch.equal(a, b) and np.array_equal(oa, ob)
    assert not torch.equal(a, c)
    assert oa[-1] == a.shape[0] == 60_000 and len(oa) == 5


def test_chunks_equal_table():
    # The reference reads the table again chunk by chunk.
    vals, off = lineitem.make_table(CFG, 11, "cpu")
    parts = list(lineitem.chunks(CFG, 11, "cpu"))
    assert torch.equal(torch.cat([x for _, _, x in parts]), vals)
    assert [row for _, row, _ in parts] == off[:-1].tolist()


def test_moments_follow_the_formulas():
    cfg = dict(CFG, scale_factor=0.1)
    vals, off = lineitem.make_table(cfg, 3, "cpu")
    x = vals.double().numpy()
    pk = np.arange(1, lineitem.num_parts(cfg) + 1)
    r = lineitem.retail_cents(pk) / 100.0
    mean = 25.5 * r.mean()                       # E[q] E[r]
    ex2 = np.mean(np.arange(1, 51) ** 2) * np.mean(r * r)
    sd = np.sqrt(ex2 - mean ** 2)
    n = x.size
    assert abs(x.mean() - mean) < 4 * sd / np.sqrt(n)
    assert abs(x.std() / sd - 1) < 0.01
    assert x.min() >= 1 * 901.0 and x.max() <= 50 * 2099.0
    sizes = np.diff(off)
    assert abs(sizes - n / 4).max() < 5 * np.sqrt(n / 4)


def test_sizing_sample_is_fixed():
    a = lineitem.sizing_values(CFG)
    b = lineitem.sizing_values(CFG)
    assert np.array_equal(a, b) and a.dtype == np.float32
