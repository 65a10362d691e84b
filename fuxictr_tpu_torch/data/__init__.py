"""Input pipelines. Every batch carries ``SAMPLE_MASK_KEY``: 1 for a real
row, 0 for a row that pads the last batch to the fixed batch size."""

SAMPLE_MASK_KEY = "__mask__"
