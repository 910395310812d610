"""Character sets and grapheme codecs (copies of the JAX package's jax-free `text`
modules)."""
