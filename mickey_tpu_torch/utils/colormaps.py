"""Colour tables of matplotlib's ``magma_r``, ``cool`` and ``viridis``, and
their lookup.

The depth panels (``utils.viz.colorize``, ``magma_r`` by default) and the 3D
render's confidence bar (``utils.render3d``, ``cool``) colour through these
tables, so they need no matplotlib (the card's machine has none). Each
table holds the 256 RGB entries that ``matplotlib.colormaps[name](
np.arange(256), bytes=True)`` gives (matplotlib 3.10), alpha 255
throughout; ``lookup`` does what ``Colormap.__call__(x, bytes=True)`` does
for float input.
"""

from __future__ import annotations

import numpy as np

_MAGMA_R = (
    "fbfcbffbfabdfbf9bbfbf7b9fcf5b7fcf3b5fcf1b3fcf0b1fceeb0fcecaefceaacfce8aafce6a8fce5a6fce3a5fde1a3"
    "fddfa1fddd9ffddc9dfdda9cfdd89afdd698fdd497fdd295fdd193fdcf92fdcd90fecb8efec98dfec78bfec689fec488"
    "fec286fec085febe83febc82febb80feb97ffeb77dfeb57cfeb37bfeb179feaf78feae76feac75feaa74fea873fea671"
    "fda470fda26ffda16efd9f6cfd9d6bfd9b6afd9969fd9768fd9567fc9366fc9265fc9064fc8e63fc8c63fb8a62fb8861"
    "fb8660fb8460fa825ffa805efa7f5ef97d5df97b5df9795cf8775cf8755cf7735cf7715bf6705bf66e5bf56c5bf56a5b"
    "f4685bf3675bf3655cf2635cf1615cf0605def5e5dee5d5dee5b5eed595fec585feb5660ea5560e85461e75262e65162"
    "e55063e44e64e24d65e14c66e04b66de4a67dd4968dc4869da4769d9466ad7456bd6446cd4436dd3426dd1426ed0416f"
    "ce4070cd3f70cb3e71ca3e72c83d72c63c73c53c74c33b74c23a75c03a75be3976bd3977bb3877b93778b83778b63679"
    "b53679b3357ab1357ab0347bae347bac337bab337ca9327ca7317da6317da4307da3307ea12f7e9f2f7e9e2e7e9c2e7f"
    "9a2d7f992d7f972c7f952c80942b80922b80912a808f2a808d29808c29808a2881892881872781852681842681822581"
    "8125817f24817e24817c23817a2281792281772181762181742081731f81711f816f1e816e1e816c1d806b1c80691c80"
    "681b80661a80651a8063197f61187f60187f5e177f5d177e5b167e5a157e58157e57147d55137d53137c52127c50127b"
    "4f117b4d117a4b10794a1079481078470f77450f76430f75420f74400f733e0f723c0f713b0f6f390f6e370f6c350f6a"
    "3410683210673010652f10622d10602b115e2a115c28115926115725115523115222115020114d1f114b1e10491c1046"
    "1b10441a1041180f3f170f3c160e3a150e38140d35120d33110c31100c2f0f0b2c0e0a2a0d0a280c09260b08240a0722"
    "09071f08061d07051b06051905041704041504031303031102020f02020d01010b010109010007000006000004000003"
)

_COOL = (
    "00ffff01feff02fdff03fcff04fbff05faff06f9ff07f8ff08f7ff09f6ff0af5ff0bf4ff0cf3ff0df2ff0ef1ff0ff0ff"
    "10efff11eeff12edff13ecff14ebff15eaff16e9ff17e8ff18e7ff19e6ff1ae5ff1be4ff1ce3ff1de2ff1ee1ff1fe0ff"
    "20dfff20deff22ddff23dcff24dbff24daff26d9ff27d8ff28d7ff28d6ff2ad5ff2bd3ff2cd3ff2cd2ff2ed1ff2fd0ff"
    "30cfff30ceff32cdff33ccff34cbff34caff36c9ff37c8ff38c7ff38c6ff3ac5ff3bc3ff3cc3ff3cc2ff3ec1ff3fc0ff"
    "40bfff41beff41bdff43bcff44bbff45baff46b9ff47b8ff48b7ff49b6ff49b5ff4bb3ff4cb3ff4db2ff4eb1ff4fb0ff"
    "50afff51aeff51adff53acff54abff55aaff56a9ff57a8ff58a7ff59a6ff59a5ff5ba3ff5ca3ff5da2ff5ea1ff5fa0ff"
    "609fff619eff619dff639cff649bff659aff6699ff6798ff6897ff6996ff6995ff6b93ff6c93ff6d92ff6e91ff6f90ff"
    "708fff718eff718dff738cff748bff758aff7689ff7788ff7887ff7986ff7985ff7b83ff7c83ff7d82ff7e81ff7f80ff"
    "807fff817eff827dff837cff837bff8579ff8679ff8778ff8877ff8976ff8a75ff8b74ff8c72ff8d71ff8e71ff8f70ff"
    "906fff916eff926dff936cff936bff9569ff9669ff9768ff9867ff9966ff9a65ff9b64ff9c62ff9d61ff9e61ff9f60ff"
    "a05fffa15effa25dffa35cffa35bffa559ffa659ffa758ffa857ffa956ffaa55ffab54ffac52ffad51ffae51ffaf50ff"
    "b04fffb14effb24dffb34cffb34bffb549ffb649ffb748ffb847ffb946ffba45ffbb44ffbc42ffbd41ffbe41ffbf40ff"
    "c03fffc13effc23dffc33cffc33bffc539ffc638ffc738ffc837ffc936ffca35ffcb34ffcc32ffcd31ffce30ffcf30ff"
    "d02fffd12effd22dffd32cffd32bffd529ffd628ffd728ffd827ffd926ffda25ffdb24ffdc22ffdd21ffde20ffdf20ff"
    "e01fffe11effe21dffe31cffe31bffe519ffe618ffe718ffe817ffe916ffea15ffeb14ffec12ffed11ffee10ffef10ff"
    "f00ffff10efff20dfff30cfff30bfff509fff608fff708fff807fff906fffa05fffb04fffc02fffd01fffe00ffff00ff"
)

_VIRIDIS = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)


def _table(hex_rgb: str) -> np.ndarray:
    rgb = np.frombuffer(bytes.fromhex(hex_rgb), np.uint8).reshape(256, 3)
    return np.concatenate([rgb, np.full((256, 1), 255, np.uint8)], axis=1)


TABLES = {"magma_r": _table(_MAGMA_R), "cool": _table(_COOL), "viridis": _table(_VIRIDIS)}
BAD = np.zeros(4, np.uint8)  # matplotlib's default "bad" colour, (0, 0, 0, 0)


def lookup(name: str, x) -> np.ndarray:
    """RGBA uint8 (..., 4) of float values ``x`` in [0, 1] through table
    ``name``, as ``Colormap.__call__(x, bytes=True)``: x * 256 in x's own
    dtype and truncated to an index, x == 1 the last entry, below 0 the
    first ("under"), 256 and above the last ("over"), NaN the "bad" colour."""
    table = TABLES[name]
    n = table.shape[0]
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    rgba = table.take(np.where(bad, 0, idx), axis=0)
    rgba[bad] = BAD
    return rgba
