"""LSH transforms + the scheme registry.

Mirrors the MatchModel registry (core/engines.py) for the *transformation*
side of GENIE's genericity claim: each LSH family is one `LshScheme`
descriptor bundling parameter construction and point hashing behind a
uniform interface, so serving code (serve/retrieval.py) selects schemes by
name instead of string-keyed if-chains.

    scheme = lsh.get_scheme("e2lsh")
    params = scheme.make_params(gen, d=32, m=238, w=4.0, n_buckets=8192)
    sigs = scheme.hash_points(params, x)

`make_params` filters its keyword options to what the scheme accepts (e.g.
`w` for e2lsh, `sigma` for rbh, nothing for simhash), so one call site can
carry the union of options.  Register a new family with `register_scheme`.
All four families of the reference are served: e2lsh and rbh (-> EQ),
simhash (-> COSINE) and minhash (-> TANIMOTO).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.lsh import e2lsh, minhash, rbh, rehash, simhash, tau_ann  # noqa: F401
from repro_torch.core.types import Engine


@dataclasses.dataclass(frozen=True)
class LshScheme:
    """Descriptor for one LSH family (paper section IV).

    `engine` names the MatchModel that consumes this family's signatures
    (bucketed schemes count collisions with EQ, minhash sketches with
    TANIMOTO, simhash bits count sign agreements with COSINE), and `mle`
    inverts a match count into the similarity the family estimates.  Serving resolves both by scheme name,
    so selecting a scheme selects the whole engine stack.
    """

    name: str
    description: str
    make: Callable[..., Any]                 # (generator, *, d, m, device, **options) -> params
    hash_points: Callable[[Any, Any], Any]   # (params, x [..., d]) -> sigs [..., m]
    option_names: tuple[str, ...] = ()       # keyword options `make` accepts
    engine: Engine = Engine.EQ               # match engine paired with the sigs
    # (counts, m) -> similarity estimate; default is the tau-ANN MLE c/m (Eqn 7)
    mle: Callable[[Any, int], Any] = tau_ann.mle_similarity

    def make_params(self, generator, *, d: int, m: int, device=None, **options) -> Any:
        """Build scheme parameters, keeping only the options this family uses,
        on `device` (None: the card)."""
        kept = {k: v for k, v in options.items() if k in self.option_names}
        return self.make(generator, d=d, m=m, device=device, **kept)


_SCHEMES: dict[str, LshScheme] = {}


def register_scheme(scheme: LshScheme) -> LshScheme:
    _SCHEMES[scheme.name] = scheme
    return scheme


def get_scheme(name: str | LshScheme) -> LshScheme:
    if isinstance(name, LshScheme):
        return name
    try:
        return _SCHEMES[name]
    except KeyError:
        raise KeyError(
            f"unknown LSH scheme {name!r}; known: {sorted(_SCHEMES)}"
        ) from None


def scheme_names() -> tuple[str, ...]:
    return tuple(sorted(_SCHEMES))


register_scheme(LshScheme(
    name="e2lsh",
    description="p-stable LSH for l1/l2 distance (paper Eqn 10/11)",
    make=e2lsh.make,
    hash_points=e2lsh.hash_points,
    option_names=("w", "p", "n_buckets"),
))

register_scheme(LshScheme(
    name="rbh",
    description="random binning hashing for the Laplacian kernel (section IV-A3)",
    make=rbh.make,
    hash_points=rbh.hash_points,
    option_names=("sigma", "n_buckets"),
))

register_scheme(LshScheme(
    name="simhash",
    description="signed random projection for angular similarity (Charikar)",
    make=simhash.make,
    hash_points=simhash.hash_points,
    option_names=(),
    engine=Engine.COSINE,                 # bits become +-1 sign agreements
    mle=simhash.mle_cosine,
))

register_scheme(LshScheme(
    name="minhash",
    description="minhash over positive-support feature sets for Jaccard (FLASH)",
    make=minhash.make,
    hash_points=minhash.hash_points,
    option_names=("n_buckets",),
    engine=Engine.TANIMOTO,               # sketch collisions count Jaccard
))
