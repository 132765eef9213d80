"""The FLOP counts against hand counts of one ResNet bottleneck block and
one BERT encoder layer, and the onebit bytes against a hand count."""

import math

from perfbench.flops import bert_large, onebit, resnet50

RESNET = {"width": 64, "bottleneck_expansion": 4, "image_size": 224,
          "channels": 3, "stage_sizes": [3, 4, 6, 3], "num_classes": 1000}
BERT = {"hidden_size": 1024, "intermediate_size": 4096,
        "vocab_size": 30528, "num_hidden_layers": 24}
MLM = {"seq_len": 128, "mask_frac": 0.15}


def test_one_bottleneck_block_against_a_hand_count():
    # stage 2's first block: 56x56x256 in, 3x3 stride 2 on 128 channels,
    # 28x28x512 out, a 1x1 stride-2 projection
    layers = dict(resnet50.layers(RESNET))
    hand = {"blocks.3.convs.0": 2 * 56 * 56 * 256 * 128,
            "blocks.3.convs.1": 2 * 28 * 28 * 128 * 128 * 9,
            "blocks.3.convs.2": 2 * 28 * 28 * 128 * 512,
            "blocks.3.proj": 2 * 28 * 28 * 256 * 512}
    for name, flops in hand.items():
        assert layers[name] == flops
    assert layers["stem"] == 2 * 112 * 112 * 64 * 3 * 49
    assert layers["fc"] == 2 * 2048 * 1000
    # ResNet-50's 4.09 G multiply-adds an image, forward
    assert abs(resnet50.forward_flops(RESNET) / 2 - 4.089e9) < 0.01e9
    assert resnet50.train_flops_per_sample(RESNET, {}) == \
        3 * resnet50.forward_flops(RESNET) - layers["stem"]


def test_one_encoder_layer_and_the_head_against_a_hand_count():
    h, f, t, v, p = 1024, 4096, 128, 30528, 19
    layer = t * (2 * 3 * h * h          # query, key, value
                 + 2 * h * h            # output projection
                 + 2 * h * f * 2        # the two feed-forward products
                 + 2 * t * h * 2)       # scores and context
    head = p * (2 * h * h + 2 * h * v)
    assert bert_large.forward_flops(BERT, MLM) == 24 * layer + head
    assert bert_large.train_flops_per_sample(BERT, MLM) == \
        3 * (24 * layer + head)
    # the 6 N T count over every parameter reads about 1.1x higher
    n_params = 366441280
    assert 6 * n_params * t / bert_large.train_flops_per_sample(
        BERT, MLM) > 1.1


def test_onebit_bytes_against_a_hand_count():
    n = 1000
    words = math.ceil(n / 32)
    assert onebit.pack_bytes(n) == 4 * n + 4 * words + 8
    assert onebit.unpack_bytes(n) == 4 * words + 4 + 4 * n
    assert onebit.unpack_sum_bytes(n, 4) == 4 * (4 * words + 4) + 4 * n
    assert onebit.step_bytes([n], 1) == (2 * onebit.pack_bytes(n)
                                         + 3 * onebit.unpack_bytes(n)
                                         + onebit.unpack_sum_bytes(n, 1))
