"""Training: the chunked loss and the train step (port of the reference's
``train/``)."""
