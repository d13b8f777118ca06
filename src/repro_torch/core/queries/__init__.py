"""The paper's three query families over one index (aggregation,
retrieval, recommendation), plus the batched engine that serves mixed
batches of them end to end."""
from repro_torch.core.queries.aggregation import phrase_count_query, PhraseCountResult  # noqa: F401
from repro_torch.core.queries.retrieval import (  # noqa: F401
    BoolExpr, boolean_query, ranked_query, parse_boolean,
    precision_at_k, recall,
)
from repro_torch.core.queries.recommend import recommend_query, RecommendResult  # noqa: F401
from repro_torch.core.queries.batch import (  # noqa: F401
    BatchQuery, ExecutionReport, QueryBatch,
)
