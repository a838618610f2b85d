"""One module per prediction network, named by ``prednet.rnn_type``
(``reference.parts``)."""
