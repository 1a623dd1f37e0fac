"""Plain PyTorch references, one file per architecture
(``reference/<arch>.py``, named by a configuration's ``reference`` key).
They import nothing of the program and read only the weights and tokens
the benchmark made."""
