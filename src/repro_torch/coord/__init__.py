"""The coordinator: a replicated KV store on the Raft cluster of ``core``
(``kvstore``) and the training-cluster registry on top of it
(``registry``: committed checkpoint manifests, membership, step times).
Both files are verbatim copies of the JAX package's, held to them by a
test."""
