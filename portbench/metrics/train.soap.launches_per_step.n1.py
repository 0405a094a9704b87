"""train.soap.launches_per_step of the cells at one image (it moves train_img_steps_per_s.n1)."""

from portbench.harness import load_reader

read = load_reader("train.soap.launches_per_step").read
