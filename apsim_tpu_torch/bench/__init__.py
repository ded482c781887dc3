from .scale import rcv1_like_corpus, synthetic_corpus
