"""Input pipeline: readers and device prefetching (the port of the JAX
package's ``data/``)."""

from recommenders_addons_tpu_torch.data.loader import (  # noqa: F401
    CriteoTSVReader,
    MovieLensRatingsReader,
    Prefetcher,
    prefetch,
)
