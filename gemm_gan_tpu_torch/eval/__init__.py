"""Evaluation: gamma, PRDC, k-NN precision/recall, privacy, the detection
and utility suites, with the few scikit-learn pieces they need written in
numpy / scipy (`_sklearn_free`)."""
