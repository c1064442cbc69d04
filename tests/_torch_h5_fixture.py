"""A small NS store as the JAX package writes it through h5py, embedded.

``FIXTURE`` is the file ``sciml_pde_tpu/sim/gen_ns_incomp.py::write_ns_h5``
writes for ``fixture_arrays()`` and ``CONFIG`` through h5py (chunks of one
frame, shuffle, LZF; ``force`` is noise, so its chunks are stored raw with
LZF's mask bit set), zlib-compressed and base64-encoded (``*.h5`` is
git-ignored).  ``tests/test_torch_hdf5_chunked.py`` writes it again with
JAX's writer and checks the arrays; ``chip_smoke.py`` phase 23 reads it
through ``io/hdf5_lite.py`` on the card's machine, which has no h5py.
Imports numpy only.
"""

from __future__ import annotations

import base64
import zlib
from pathlib import Path

import numpy as np

CONFIG = {"grid_size": [16, 16], "fixture": True}
# name: (chunks, compression, shuffle) as h5py reports them
LAYOUT = {"velocity": ((1, 1, 16, 16, 2), "lzf", True),
          "particles": ((1, 1, 16, 16, 1), "lzf", True),
          "force": ((1, 1, 16, 2), "lzf", True), "t": ((1, 4), "lzf", True)}


def fixture_arrays() -> dict:
    """The arrays of the store, from a seed: smooth fields and noise."""
    rng = np.random.default_rng(23)
    t = np.linspace(0.0, 0.5, 4)[:, None, None]
    x = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    vel = np.stack([np.sin(xx + t) * np.cos(yy), -np.cos(xx + t) * np.sin(yy)], -1)[None]
    par = np.exp(-((xx - np.pi) ** 2 + (yy - np.pi) ** 2) / (1.0 + t))[None, ..., None]
    force = rng.normal(size=(1, 16, 16, 2))
    ts = np.linspace(0.0, 0.5, 4)[None]
    return {k: np.asarray(v, np.float32) for k, v in (("velocity", vel), ("particles", par),
                                                     ("force", force), ("t", ts))}


def write_fixture(path) -> Path:
    """Write the embedded file to ``path``."""
    path = Path(path)
    path.write_bytes(zlib.decompress(base64.b64decode("".join(FIXTURE))))
    return path


FIXTURE = (
    "eNrtfQlcFMf2bs3CKjAgIKJiF8uIBlD2fXoaQcGFgIoKGnEAnSCMKFEQFWEEGQi4BCTgggoCsoniAoREpkEwuCSA"
    "iEvEBTFuiA6LiNEkvuoBctWL17z7fr933/vf+fyNPd1fn6pTVec7p+mW9msPt5mqyuOUAQVFRcAE6uBdvB2C5/r3"
    "94d53tCWNrRNGtoW0oePM6Xc2KHj6kPtQ8bgfvbQcZ/5M2ZQZ7/9AMP93GAObhWBDP+N8Jjh4k1tfYf27Ye25+nv"
    "nxe5UrAmaNX6jcP7awO+Wr8qSLBy3dA+f81XQSvRdv0HcQs/0q/GULx+GNcqgBiyVwBaKCqD1oTxV30JgC6NJrVQ"
    "/6ttxff6mfxOENOk7dgPfVdBfxSBIGD9ynXrZ4WtWBk1qBfF4dOJ99ph/OW/nPSYIm14f3CGaHK0985n/qW/97f0"
    "D+bhU+cxkJKpczUgNnQuBDqKQCd2iJdD3lI8nUGXNjkK+U19odGH26F4GlgXHMHnC1b+1R/YQh1nAMEm/l9+SIeg"
    "OKz7yYP90+WHcwlt6DM83fR33AcLPvdyo3LP5KH9A/P+dXwN5yco/6/PMx/a9gf/6/OG81QN4/9v3f2fxhftb8YX"
    "7T8VX8x/iq81diPHF+3d+PqfAndXr7m0dxbivTyFsNngy69WrVi+btWmlQaOcKmFrSm0sF1mCg34q6LWR3xFHVz/"
    "VcTKLcPtfceS1SoZZJBBBhlkkEEGGWSQQQYZZPh/DdR9d+o+2Yf33Zv+zftW3kM3Dn78wJ72N+0x08HtuQ/s6X/T"
    "/sG0ke3/7nCKrUb2e3j7sfuiTFkoySCDDDLIIIMMMsgggwwyyPBfBCX00QZ9wF/6T/z64ChgCRntdBacoNbXGjFu"
    "U4n/uE2tEX192o1CFhBmsxT7QEQrAK0R8pCNTEbR+uQRUZ/N0vAHm8ZFtPb1NWr39UW0bhrnX4KI8mwWjJQv6ZPX"
    "brS0hH5Mef8SsB4dv5jNatfhtuvEtuuQKpagUVu+r8R/PSjxl4f5NEtLdMaxd86Ab9WEffXa5ZYXtcv76v2F4NgH"
    "TegPMCXoR/p4qEB96BJgMTwIZgrnZRyMfxmXwmEyJeHIbiwaBBNwUgBI4ZQODYJZiohaNIh4EPeSk8JkhkuYTE5K"
    "3Mt4iIjibBaapnjILJWEW1igUZTGQyBGxIV3R2EBwiWlTBgvBjC+FI3CwgKdceD9UYxl1kqKLS5Iipm18WPBgQ+a"
    "0B+QrwM2QACEaCls0FKoSkehUQfKy5ONtZfcEGgvSTYuL6+jI8PD2SwVG2CcDECysbtNsjE1DJsGRGijYQjAEm3j"
    "5PLyuLrycuPkJdoCX0S4UmuhdsPGvS5ux466OBt3wQ3heHR8wTsuaKgCel2Dja9gvNBX0GBDr1NVRWc8eX8Uh220"
    "61x3LKhztdEWHBY++aAJ/QG6GJAEDQgJmrxYmC/EhVy0BwjaKBwX4mKcxElDUox2xeJ8MS7mirl5XBydgcPPaGIu"
    "xIAR1IOALibzoAocDfKpPSEGLdFxR6iHvs2n5ePQiZiuLOTmcvPwPKM8cR50oueSyTBE2UhslG+EG3GNuIZwG2TT"
    "cdwIWkE/gPOC4ZxsERDzMGiAmlIGZDtIQr3kw8+gOk2Mw7OQgB5EOUwCbOgMMeII9GaI2YDNCwbK8LJ8Hjcfz2fn"
    "85JAMgymGZHQFIWOFXQCuTAIuqN+2MIkQgLdgVjfEeCExIUFAcCFSXScZP81hLzhIUA/iPMwgi/PzmPjbC4bcogk"
    "oQgNth7k6acjv8VoTFZQlBPVDkTIeeQ00URIhElommbrZ+izaGIh5SXq/TNCUhvlMo2BZhLXKAVzlWc2Xwo433Ep"
    "YGbzXOXSxWh5xqCQ2APqw5JsyyN+biiPSLKtD9tDBbA1IvaCC/UKlQsPXFFceECh8kL93kxEHETEa4Abmi+3qmo4"
    "b1Vlvhw3fH0WESWI6AABl5pnKs9dXKo8t3lmwKWO84iIQ0QDiCi3TQqrF+8Jq7dNiihv+BkRuxChCA4srFSov5C5"
    "t/5CpcKBhYpXEHEfEedBldVyc0P87GtDfLl5ldV5KoJTs1mgtP3lW4120GuPxzGdA9cxnfG4Xvt2Z8QmI7MbgD5a"
    "L6xnw403PRv0wuijb1DxfQ4RyaDYI/JNlpni5iyzyDfFHsmUayJERIPY/JCZfXJ7t/TJhcyMzY82QgQfEeuAMzMO"
    "t+91brfvjcOdmesCEXETEW/Ahp4wvdF03xuj6WF6G3re3Bga5WZglvUm0qP4fLJH8ZtIs6zNiog4iogtQK5vZkh+"
    "rFF0fuzMELm+LXsR0YakMfBWYwqYUNttGbfKKTpuVbflhNopoxCngowUwJsjNbpeHtq+Xh41um+OKEgQ0Y4Ib0AE"
    "aV4+pMTXOqSkeZkI8s5FhCkiNgL+cXMDsc/XK8U+5gb84xv/QMTn0jGuirPsrp2QMqV2gmX3qrjoHxDhjQhf4OGl"
    "W3PkzRqFI290azy8fL9FhBUitIDSocuaQYShdxBxWVPpkNZDRPQjYiXwERuYH+dv2Xicb2DuI16phAiOdCjKlIg5"
    "JAeJuBrSVMRSFVdzq5GKOZCGdIAkLE+J3IgSuQKSsVTkKFSRyCGGNK1PYASkIXmbQn2pvOkEBqohRhMbwSUQo1eT"
    "uVDARJmCkjmK90CqNjE4lJI1oW52Eg+pGDpQFjAYfdwIP0rbqCU3YiOBQQiQB1AN6sMkIhidS0Jr1IAzasYQzob6"
    "dFxM6VuEtBgCvZHOgFCCVGQIOFBCw9lbWSg5GKLGg5EhBu3aaRJeYbaIJ3Uc2RyB9OxBTXdBOuQSwXQxnkeIUC7J"
    "FhFJKHXzoSRgkUsUD7mJ2hJCNjwJmwhRdhJq7abUwUS0rybE7jGGRBwYEAkLt0YBjv40/Qw6pWJ1sNNU1TqtUP1U"
    "WqGq9U5T9QI0/dvRutwG7cfxMLrl5Hq6JR7Wfvz2pSGxVgKb5bdLIjT3B0Ro3i6xWV65CBHrEbEDlFfNs6hyTeip"
    "cp1nUV61Q4AId0ScAoVp1qqmOwvUTXdaqxamnVJHxCZE1ANLehh+vP3S7ePtYbglvX4yIm4gIgBoRpTcXm6zqHK5"
    "TcltzYiA/YggENEDXKss5lWVC3ZUlVvMc63qSRgsUECdUrEInJvUqWYXc/GxXUyn2rlJolDEZiKzfiCX8IW/9p1N"
    "a7XvfOEvl9Bvgoj9iPAAtWZX2UQOs4DIucquNfM4jYh4RGwHY9+eup6R0MPMSDh1fezb7ZT0QhDxGMTYqXVOOhcq"
    "mnROrTPG7vFFROgjYi24o+3/RYKcSX+CnP8Xd7TXbkIEDxEFIIdgXzWrPe1hVsu+mkMUMBGhgAgmSMi4furtWMXt"
    "b8deP5WQwewZVCql4gKwr0pgApZ/Fw6WC0z2VRXIDSWkKUAvrVshztyJG2feraCXNuXKkLz5wMfE4GBZY8zdskaD"
    "gz4m/EhE4IiIBYIqa5M63vZ1dTxrE0FVrPxgHYV8FKxjlPclFFTtMxEsB+H26LgHMuAC8ziF7jS9BVPS9BS6zeO4"
    "lLonIuIuaCw7aGDi85Jv4nPQoLHs7p+IqELXLOsAr87EukogioUPmda8unUqiJj1DxF/rBIzcK6Qy0N1mNBDGmDS"
    "8ki0k492uJCJglif0ikqY0CMYhnJabAYY0LuGW41Xm1ULa4mq8kzZC7pTHLEnHwOzuFyuM5cdAUgrcaoyuHCYKqq"
    "ibMxGhdVYqhXg9FQHVaGo5GYKKlOB4aEClSrSUJy02egdAOQzpy5BgQlMTaBpAaTaEPCdR0uvkIJQywmAXSDS7ey"
    "oAFSvx+q5J0BLKnP+GDpLYTz0cE6CAkuTwKQcAkJ6gtVVaHIhVKrITQBVOHlDxXebIzXJPUPlWjkKEoeQql/ue/4"
    "h9KfELlymBBBCZKxs1BERzOh4QaeVI+m68y7RejMG01/Uu12YfB6T2MBWHzlmtBdT5DirndNuPjKAkrdGogYBWxY"
    "4Rz9/vF9+v3hHBvWKGtEFCFCB0xasgbbnzPv5P6cNdikJTpUjf4NEQSYp0MfXf3kglv1E/roeTrELURkICIF6LkL"
    "r11ZXLDgymLhNT33FEr2WxDRB/r1OeEsG+tRLBtOeL9+H3UJ2IiIkyBnP7ZmyaRMnSWTsDU5+0/OQ8QJJGI3SsQb"
    "QENv2q27uwKK7u5Ku9XQu6EZsaOR2TJg3vJqQob/k8wM/1cTzFuWUYVVgoh80Ftwso1uuplNNz3Z1luQT0OEPSIS"
    "gfGd1zqNhwN8Gg+/1jG+kygZrPkaRWDX3VtpvQ3NG3obbqXtulsUgIhbiMgE/hkTXrWYGy1rMZ/wyj8j88lgYdVg"
    "A1N628mCXlp+QW/bSVM6ezMitiLCBxxu1Hl9x1iSeMdY5/XhRh+qqXWDIu4HHSWlE528FHhOXqUTO0r6BxB3CRm5"
    "A/sIlft7tJbCPVoq9+0j3E8gwggRESDwltmcMwmJ35xJMJsTeCsCQ8QcRMSAUGOr/Wcvbm87e9Fqf6hxDPUDxnxE"
    "8ICX08TSko4N/SUdE0u9nHiJiHBABARae+6rRNhbuEfY31fR2gPbEMFExDcg4cwcs1uBhyJuBc4xSzjzjQIiwhDR"
    "Bi6e3W9lHNoTYxy63+ri2TaVwZ+r3lWx0ZCK895RMR2p+BPF1hFKv6LKhw3KmIkjqaJiK49Ea4TEC3XpqM5DQ3kk"
    "6nwk7uGqO6hjVAdR4kB6phIBlEoZXcALMSIYdaRMw0m48Z3CWzlUeAOlhfc6XVwNhMHgMFV4KVELUb2UihqJz6FG"
    "UkNdS3+JLs8Bbya6Ti766zoauT8k3CSUoIaL7naIjiHdVXNz25kiakAEvzZSSF0WsGupBABhE/wZSogkpHI2/MyF"
    "Kr3S9IGuCHJQ6RWK9CfSONQhaZLJieIhEXPwjz1u30z/937cJt0Ht8n0kR9bfwqOswe3QR/Y/1136ucObiM/MPi7"
    "j9uNvUb2+2OP2z/8NRIZZJBBBhlkkEEGGWSQQQYZZPhvAPaZz6NGMmFbrF/stgSy8ZGPT//arbF6Jvfb7pvoxW5d"
    "26/4aG1Ds1t5Wbk8ZGBuzQ1rG7c23/faVhHtHV2xzet+81Yy1s3rV28f6AR9vLFfvdxiE/TKt3mbiINAkNjEe1u5"
    "3jaTsgof8e1ve7+9LcZ8KspMYu+XR8Ogb7s53d8Gwejy+35t8t5OoJcDOL2A4eQt39augLUrcNsVlrcrxLYrHGpX"
    "INsV7mI3XJJ7pmYadfd0G2VO7Ul2cTk9Kbe7+eFDxYcPm7tzJ53Gkieddt8lcXnr99ZFssv99KSeXPeHHhPZB/kH"
    "2RM9HrrnYlO7d3kU8dfdOnZrHb/IY1d3ZrNkIt+0i5XB6jLlT5Q0Y0YPXdjrunSb2E26XevYLg+7H749eIvVpBai"
    "1sS6dfDtQ1aPoh//WAY7BISwM47x/RRH9HSc3ePFabt9Ox18HTp9d6ctfvw4TdHBQXF3p1LnbkIRS1usGH306BYl"
    "vxg/pS1Hj0Yrpjkc7Xxa6pRemu5U+rTzKNNht8PRp+2Apff0qIOv4pbS0lilpbFLlWJLS7codu5WcnJS+rZLuetb"
    "QlFzt0OnX3r60i7npc5dS9PT/Tp9lWLgNKbyUuFSZTiNFqM0on9jLSytbWzt7Ozt7e3sbG2sLS2tbe3sHRwcHCGD"
    "YW9na81Tozk6EQA4EurABurRHZ2cCSBUB/aEGuBQ33hqACcAT51h54AoNcCFGlCd5mAvZNG4XKjOY8G56EQ1qA5Z"
    "wHEEH+Tu0mytsVOOeuPig8Nmr5odFhw/Ts/RUXFfzOwKM4FQYFYxO2afIqa377T+kZ3WwlSh9c4j+qf3jYvRF7if"
    "H2ekbDTuvLtAPwaLn33EXah8zqzP7Jyy0P3I7OCKneeV4Vl7F/uzUPn8zgoszMx63LmzLqIOkcvZc+OszWYLhEZm"
    "9qJ0QbrI3sxIKGCtEqYq97l0CICgw6VPOVU4cuiRbx7GrLDuzDHI6bReEfPwzZubIc9yNp8sKyw7uTnnWchN7GGI"
    "F5anXeie7F6onYd5hcQ8w8rYGq71QfWuGuwy7Bm2IiePvSHoQLRm9IGgDey8HOvN2hpBx4pEl0VFx4I0tDdjnScL"
    "XQ8UXbO4a3Gt6IBr4cmcMvf6aJFFomeihSi63r2MZVCYHKR5+a4n8Lx7WTMouXBkT4ljffRrifTp/tPpidfofceO"
    "TVwmmN6/uuxC2er+6YJlE7G+ZfvyE03yX6q8zDdJzN+3jC7IL0u1O8EYwzhhl1qWL8CuTU9MDRuTemPgRuqYsNTE"
    "6Yn9JnZjqu2S9ifZVY+xM+ln0Ffnn4DT6MwxTDgNO5G/enrZS8aNJKYbz42ZdIPxssz/gsqYgf1jeELemP0D9DEq"
    "F0b0VN7K2gaFoAMB5FEU2lhb2xKqKOAAcIAaNFsbqMZ0dHJycoYM4IgCSk3e2ZnD4Tg789ShHqFKxR5wIKRRCA1o"
    "Tg68ifI4zuVycZwHGY5OHGnw0Tgc6ILMOUhLNGfHdiUMerXT/ykS7WyxhNVPHhxuAmIrMWg6/ODJ6tXX53qKFzd5"
    "zvJsWiz2nHt9wpO5u6LiYp8R8cSz2LioXXMfeEZ5/mbqdN3/upPpb3AUdlgc99tj/+YM7Yxm/8e/xYmbFsea+qvn"
    "ra1am6fubxq7GANNz5ya89qUWpTa8pqdnjWJPYnrGWuVnqk/U1qbcZ3wZFnNivfXrmpRB+otVdr+8bNGXt5y4fh+"
    "2tWFoR2hC6/S+scLhduiTEIZR1pSW44wQk2itmHjo0RWRl18yVkJv8vIShTVb2LVci9Jb6PnRr2key1WJhgt1Oie"
    "l2eub5dvrqfXPaPQq4yuJM+AEtWfVEsCPJO6GNjCI3y93JKB9KnpAyW5evwjoS2Sjb6q6frK+umqvhslLayO1LOe"
    "XT9NVQbKU3/q8jybOqKnSg2qmOqFgAtqmBqUg6MUVT0CZqllq80K5MkpB3hgAVsC4SkYGMOTo28JUOXpMlmzg2az"
    "eGylC2pQ7WLQRRZkUWZKAdmnsoPeBuWczqF2IUbo0lj6PDkaVIN+8rNZOaw5K+ZAudGzA2dhgTFB8LT+CuEK/dMw"
    "KCZwyCvl5e1MqVeKZLv8XRaV6FCmc3R0dHBA2c8WtaMCUKqDo+koCqEa3YlKdehvRxRWKB+qUvmO5uxMqAvVGDiO"
    "c4RUSkPRheIQAieeGh0FXTZ1DB881j6GNUKys7fDVOS7QzW9N7Y2tG701gztlpePEE5spZ3yKPA4RWudKIzAuoVW"
    "kZnPFrc+bl38LDPSShg6MdKjcozfadfTfmMqPSInYpqtmZX5rhm1gtoM1/zKzFZv2rMxrtpF/m3+RdquY57RsI2n"
    "FvtlFDEX+S9iFmX4LT7V6tF6utZ/URNsWuRfe7rVg9VQ8NhV0OYPAfRvE7g+Lhg5xnwML53b4mpr9sLM1nXLuUuG"
    "hodGmZhl9tzOvd2TaWYy6hB2aVTHCWu+bopXii7f+kTHqHMmJ27/GUvyK/hk7J+3T5hgW8ys/8yqYPgW+jIqsv60"
    "NnPN5MdWdCUZDhgmdVXE8jMx2x5dkpHUO/74+N4kBqnbY3Y7he9rOD70j9Dxhr78lNusF7leFYUDx/8AfxwfKKzw"
    "yh3ZU5oO68529fC88rxw9e13WDo65pPpeZO3k63k9sl59MnmGGsyNpAFRRUXK0QwawCbfIc+QIa/8tqRtcPrVTg5"
    "QNfcnpcVPjaLYTnDkpE1NjwrT30yfIVyW+XFSpTbXsHJ4dtFXgxRu+4U3XYRw0u0PY+s2GFZqevN99attBy9o4Is"
    "b72YNePiFL6QP+XijKyLrSM6KieNOkchYFJBZ4cSnZOQqq4acALNyVlIJTPHwdIKqASnRudwUGJD6YtQh6ZCNRrK"
    "avrDwYbOdRKyoBqhTpjzMKjarsUiYDvg8rwJQLwfdQ72NCA/+MTjr5dveQxumbR/+ZSE/omnKP+pl7kJh2jFodft"
    "MehypfP/4erwy7beeZHb+697HHx6pv5PT8+E/xtPrCj08wa3H9p96qlZRMDIdp/qu/8jdp96ShYROLLdp55+9X/E"
    "Tu5T/QWNbCf/qf4+Yqfwqf5WjGz3qZd89n/ETulT/a0c2U75U/19xG7Up/rjj2yn8qn+PmKn+qn+vhzZTu1T/X3E"
    "7lPvcov44CWIH3t6K/slaRlkkEEGGWSQQQYZ/pOIPvlkXeOrvbv2KN+/OSP+91nn10+u9vTbq374ateXZcZPUg+3"
    "iFZ1aXXDmF+v9dspquzdGNK/ZH3WoyhV8phPlye2VdV/tdYtxeDxPgv2KB6o1V7lwMyKzyjXqzy6sMDNwTqmiYtX"
    "1+A1XOqGJinmkmKSFONiMckhOVyymiDJ78ULo85s25Cdyvlaftxb1UKBMzNnRYzl1pAHL6twrd5vRLO4+S8mH1Jh"
    "z9X5LlDU4VuZfVPpiiH2nPxBZY1/TGb4zUf0/RrpY36L/2JvgSRjt2hb8flVjQdvprFWPxldQlzZLOYSJNeJJLkk"
    "zuFypS7gJEniJJfDreZWky+ahZhv2Zd7PUz2PrmTmMtblLfpgWX2KfV5xvfqixWbb664p3Fgvf2fG4mTGhWRVx88"
    "72SmWgq3ZRS+8Jv/+FRmw8LMTRoaWlWRBb8FThqv890tpd47wfTUbZfHN1l/XkUmPNrA5RJozDWowxrUtRh1Lka+"
    "oOkgqQkRk+u4IZ2vlvFCrty2uSXZ2qZF73hkcabl9Kibc3p+qX6lNzp/roVmgPbPbUU7Z6gULOyrW/9N1tZtJj75"
    "Hqc9Uz47v/4Xt+8kJe7nE6rb1yiPU3j63eWGFw4Djx5rVz7IhN0ljNBgUjpertiZ6tYZ7XFxLo6TZwbngkuezHwZ"
    "yGg0KJh89knH8wH6Nu6cZqeCRP1yrl7P9xnK8lvPLTk765zJ0/unfjKb5dY19fcFb/cvPFaXz066eu1CU9XC8bBu"
    "4UZW6ZmM3c05cnvml06ZlBXXdLXZTKNlU5/xGYMf3aR3sqvPUMuPVoBEq8HholngUp3jYpwjjHpQWuzYfVd9ZXLe"
    "9aI/JxgwYOa0H3tSzs6rPRyVlHzZbuWRg6/qTR79UBWfspJ9sPD1nmVh3ited4RPeb4Pe2CaXdw15cSuyAbfot+7"
    "w195Lis7VclQX/tNYqQb26s0w6bgF664mqSijhRzqBGjYZOURzhJuVAj5toW3qh+unS8jbXn1nLsVWR0cP39L24U"
    "G//63cNr4+y/1V+XczNn+tHr2vqBWUcjuxZcHldRldfp7fvrrh/9L6bnXFaLXP6ddib97NP1bYrXtea3sXu2kL//"
    "YRS/gsHvXSI+EP3FC+nAUaekdLq5yBM0fhL5RFZLp2bs01OV006v7NHWe3ZA8fmiBZ03IjfMK8s3bXT/bE5K1rgu"
    "q0P6wXKs4vDM0q2kKOz7NWOv+SbyPx9Y25HoaRlX/OpNnGv6+bRQ82W+9o9Vf/5+5x24pgYXiX8ZtS1p3NVU1dXq"
    "3Gpc2jHVNQo3MRX6OBcFP06gQ2LuFONs70WZm+vkr3B+6341/Vonru/2o1Px9K24WCR348eXK01tH+SEJnn8pgfL"
    "Z76pupywZeqlF2d+xxKvzFD/ujZmyooQuwN/CtNSljrRxC1LCg8tzdbn763UFpLadXHrnQ1qzoilg68mxTVcac/V"
    "1BJQa4C+oskQEPQ667Fl25d+C+i0ZX8sL+ly3e3GivrJbvWy3i2P/Ryiw8J3VczbIak0nzrZdc93r5ueWJ18Afft"
    "0s6hfWZ5cM/eiqVHsnwWr7U4Me/1MVJrVb/Sj3q9EVnWu4HQeP+8+aVbpQuOUxNAzTuKvzNUz1TXNdUkp5pUteFd"
    "vOf+q2AAk3xfYTu1rM0/98dMyTcuo1eo57kfXlUSs21G06/ngtLtP68sqHyclbS/Za9K6P15Py2TKziQ+aiPPnB3"
    "+jJnnW2FWq5PDB9Pu7bM9ZHmc83U2cVFotr5neKUA2KcWn8cLQIHJQLUL16Dc5A/+A84FQX4n/c8DN23fmU03TKi"
    "UMldIt7q+03G8Z+UbuYe7vw8775W5ZGJX8Ie9vTv06zdS3q9J3w3PdW4zH/5sTtvQfDGzKeQwXQxvmyWOPtrzdlL"
    "tvVbFHLmHwxZGPdToQj2HP553/eFKThKs9S0o/xHDqZA8gyHSsUoKKiU8LC4JCrCMe/5slRQzvhl1bgX95/jpWSz"
    "Ujp91ZVr/bk/D9Q/0djwyGvmmd43xN3wcpsY0jzq1Hld55MzXKf5zhdfzbTc6ojXFulUx4/ZU5Nxt2tyUUI07k3z"
    "nH9PgbgWezcXzTwHLXMNKa0A1EKQ3B/ENYNRwT3zw4Vvd4dUPHj5/NL5WZdrR23csDHW7oupP83XWeAYs7Sjpf7R"
    "9/5+/vsCtZR+/ipXa7PpHpU3xeYdm/Zj2dfyZjzdUAJfrpnrSduncyx2jWfSeT/s0HYbAXfHRN16owsxf6jkJN6b"
    "xSUJaQBQa4C6dqbSDiGWSg/5hJLA+nv6yZ4PSl/rliZmi8TRK345/Y1641c3K6700mb9/urBrzNs08+aFO3//NiU"
    "ebvnte4sNvLYM+Dcm/BTyLqdGmMX0TZ6lmIHtl/dEfemUKAdH5739Hk10+W84rmWq7erjNPi88QoASGhcfDqalKa"
    "e6TBiIulSQGl5jClCd7pe9iv7/d8OWVxAyi5s6NKf9oLBXzg7PM106Np5m8bin81Sr/zWblfz9IWa8+UlH1aYZuV"
    "mlavNFl4gBD/XqKpfXjC9/1Q7pjem9N66Yq2UT98XRa8c+Gcr7Qdiy1Mxu+gpp9aZ7KaeqpIomjkUiGJXKih9ED+"
    "8331wbcW0ugj/6cWH+7/375vrv7XfdGxQ/fNGXIh/3CN+Q/XzP+t66HB++r//J8vqX/i3jZn/cj3/5iy+30yyCCD"
    "DDLIIIMM/zNRUgJAcTEAn6EPutT+X482RNw="
)
