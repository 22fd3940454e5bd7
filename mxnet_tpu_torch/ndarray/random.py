"""``mx.nd.random``: the sampling entry points of ``mx.random``."""
from ..random import (bernoulli, exponential, gamma, multinomial, normal,
                      poisson, randint, randn, shuffle, uniform)

__all__ = ["uniform", "normal", "randn", "randint", "exponential", "gamma",
           "poisson", "multinomial", "shuffle", "bernoulli"]
