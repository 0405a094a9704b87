"""train.soap.graph_share of the cells at one image (it moves train_img_steps_per_s.n1)."""

from portbench.harness import load_reader

read = load_reader("train.soap.graph_share").read
