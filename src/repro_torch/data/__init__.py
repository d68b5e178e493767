from .synthetic import (SyntheticCorpus, make_corpus, make_queries,
                        random_genome, mutate)
from .fasta import read_fasta, write_fasta

__all__ = ["SyntheticCorpus", "make_corpus", "make_queries", "random_genome",
           "mutate", "read_fasta", "write_fasta"]
