"""Corpus generation, the sharded document store, the tokenizer and
the LM batch pipeline.

A shard (fixed token budget, rectangular arrays) is the cluster
sampling unit, the unit of data placement and the unit of fault
recovery.
"""
from repro_torch.data.corpus import (  # noqa: F401
    SyntheticCorpusConfig,
    generate_text_corpus,
    generate_review_corpus,
)
from repro_torch.data.store import Document, DocShard, ShardedCorpus  # noqa: F401
from repro_torch.data.tokenizer import HashTokenizer, Vocab  # noqa: F401
from repro_torch.data.pipeline import LMBatchPipeline, SimilaritySampler  # noqa: F401
