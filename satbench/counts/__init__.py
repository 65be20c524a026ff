"""The yardstick's arithmetic, frozen with the benchmark: the card's
published peaks, the operations of the model's work, and the least time
(roofline bound) of each kernel's call. Later changes to the program
cannot move these."""
