"""The yardstick's arithmetic: published peaks, and the operations and
bytes that the measured work needs for the inputs a step is given."""
