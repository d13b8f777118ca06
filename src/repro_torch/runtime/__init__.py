"""The query-side serving runtime: executor, semantic cache, generations."""
