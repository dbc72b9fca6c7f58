"""Tables for the per-lane fetch tests, shared by the CPU tests (against
the JAX kernels) and the card tests (kernel against plain version).

Their fetched values pin down the id step id = (id + int(v) + i) mod n:
negative values (the floor modulo of a negative sum), values near +-2^31
(the int32 sum wraps: 2^31 - 128 plus an id above 127), 3e9 and 1e30 (the
cast saturates to 2^31 - 1), NaN (the cast gives 0), true +-inf (the cast
saturates) and, for the one-hot sum of 8 columns, finite bf16 that
overflow to +-inf. In the one-hot fetch a NaN or +-inf entry of any row
poisons the other rows' sums (the one-hot product adds 0 x inf and 0 x
NaN, both NaN): with many special rows every lane's acc is NaN, which the
CPU tests hold to the JAX kernel by NaN position (POISON_KINDS), the NaN
payloads being the hardware's.
"""

import numpy as np

NEAR_2_31 = (2.0 ** 31 - 2 ** 23, 2.0 ** 23 - 2 ** 15, 2.0 ** 15 - 2 ** 7)  # bf16; sum 2^31 - 128
BF16_MAX = 3.3895313892515355e38
SPECIAL_ROWS = {
    "negative": [[-3.0], [-200.5], [-1e6]],
    "wrap": [list(NEAR_2_31), [-2.0 ** 31], [-2.1e9]],
    "huge": [[3e9], [-3e9], [1e30]],
    "nan": [[np.nan], [np.nan, 5.0]],
    "inf": [[BF16_MAX, BF16_MAX], [-BF16_MAX, -BF16_MAX]],
    "nonfinite": [[1.5, np.inf], [-np.inf]],
}


def adversarial_table(rs, rows, cols, kind):
    """(rows, cols) f32: small random values, a quarter of the rows
    replaced by SPECIAL_ROWS[kind] (left-aligned, zeros after)."""
    t = (rs.rand(rows, cols) * 3).astype(np.float32)
    specials = SPECIAL_ROWS[kind]
    for r in np.flatnonzero(rs.rand(rows) < 0.25):
        vals = specials[rs.randint(len(specials))]
        t[r] = 0.0
        t[r, :len(vals)] = vals
    return t


KINDS = tuple(SPECIAL_ROWS)
ONEHOT_KINDS = KINDS
POISON_KINDS = ("nan", "nonfinite")  # tables whose entries poison the one-hot product
SUM_COLS, LANES = 8, 128


def shuffle_table(rs, n, c, kind):
    """(ceil(n / 128) * c, 128) f32 for the shuffle fetch: small random
    values, column 0 (the one that feeds the next id) holding the sums the
    one-hot step would see over adversarial_table's rows, added left to
    right in f32."""
    groups = -(-n // LANES)
    rows = adversarial_table(rs, groups * LANES, SUM_COLS, kind)
    col0 = np.zeros(rows.shape[0], np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(SUM_COLS):
            col0 = col0 + rows[:, k]
    table = (rs.rand(groups * c, LANES) * 3).astype(np.float32)
    table.reshape(groups, c, LANES)[:, 0, :] = col0.reshape(groups, LANES)
    return table
