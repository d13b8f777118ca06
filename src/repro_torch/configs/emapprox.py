"""The paper's own workload config, copied from the JAX package's
``configs/emapprox.py``: PV-DBOW index training + the three query
families over a synthetic corpus, built from the port's own config
classes."""
import dataclasses

from repro_torch.core.lsh import LSHConfig
from repro_torch.core.pv_dbow import PVDBOWConfig
from repro_torch.data.corpus import SyntheticCorpusConfig


@dataclasses.dataclass(frozen=True)
class EmApproxConfig:
    corpus: SyntheticCorpusConfig = dataclasses.field(
        default_factory=lambda: SyntheticCorpusConfig(
            n_docs=3200, vocab_size=4096, n_topics=16))
    pv: PVDBOWConfig = dataclasses.field(
        default_factory=lambda: PVDBOWConfig(
            dim=64, steps=2000, batch_pairs=4096, lr=0.01, temperature=8.0))
    lsh: LSHConfig = dataclasses.field(
        default_factory=lambda: LSHConfig(bits=256))
    shard_tokens: int = 4096
    kmeans_allocate: bool = True


CONFIG = EmApproxConfig()


def smoke_config() -> EmApproxConfig:
    return EmApproxConfig(
        corpus=SyntheticCorpusConfig(n_docs=400, vocab_size=1024, n_topics=8),
        pv=PVDBOWConfig(dim=16, steps=100, batch_pairs=1024, lr=0.01,
                        temperature=8.0),
        lsh=LSHConfig(bits=64),
        shard_tokens=4096,
    )
