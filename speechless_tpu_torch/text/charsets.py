"""Canonical character inventories (the original speechless `english_corpus.py:19`,
`german_corpus.py:14`): the port's own copy of `speechless_tpu/text/charsets.py`."""
import string

english_frequent_characters = list(string.ascii_lowercase + " '")
german_frequent_characters = english_frequent_characters + list("äöüß")
