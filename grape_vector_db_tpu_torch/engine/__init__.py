"""Query engines (reference L4): unified planner, hybrid fusion, sparse BM25,
filter engine, result cache."""
