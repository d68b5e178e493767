from .synthetic import (SyntheticCorpus, make_corpus, make_queries,
                        random_genome)

__all__ = ["SyntheticCorpus", "make_corpus", "make_queries", "random_genome"]
