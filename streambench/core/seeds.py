"""The seed rule every generator draws by: any whole number, negative or
past 64 bits included, seeds numpy's PCG64 through its value modulo
2^128. Imports numpy alone, so the references that read a generator's
constants import nothing of the port."""

import numpy as np


def rng_of(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(int(seed) % (1 << 128)))
