"""repro_torch.data — corpus containers, synthetic generators, and the
streaming CorpusSource/SegmentStream pipeline that feeds the Trainer
out-of-core (port of ``repro.data``)."""
from repro_torch.data.corpus import (Corpus, Segments, ShardedCorpus,
                                     assign_segments, corpus_from_docs, preprocess,
                                     segment_corpus, shard_corpus, vocab_placement)
from repro_torch.data.sources import (CorpusSource, DiskSource, InMemorySource,
                                      SyntheticSource, initial_z, open_segments,
                                      save_segments, segment_order)
from repro_torch.data.stream import LoadedSegment, SegmentStream

__all__ = [
    "Corpus", "Segments", "ShardedCorpus", "assign_segments",
    "corpus_from_docs", "preprocess", "segment_corpus", "shard_corpus",
    "vocab_placement",
    "CorpusSource", "DiskSource", "InMemorySource", "SyntheticSource",
    "initial_z", "open_segments", "save_segments", "segment_order",
    "LoadedSegment", "SegmentStream",
]
