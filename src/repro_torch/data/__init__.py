"""Corpus generation, the sharded document store, the tokenizer and
the LM batch pipeline."""
